#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):
  1. Print the card's name and power limit; build every CUDA source of
     drynx_tpu_torch/csrc with nvcc (one process each, in parallel) and
     print the ptxas lines (registers, stack, spills).
  2. Run each kernel at the shapes of the main path on the card and hold
     its output against its plain PyTorch version on the same inputs, byte
     for byte; time both with CUDA events; print each kernel's ptxas
     registers, stack and spills. The Fp inverse runs at every row count
     of the cluster survey's launches (CLUSTER_ROWS), the reduce at R = 10
     over 180 columns and R = 3 over 90, the Fp12 product at 13,500 rows
     and at N = 1 (the final exponentiation's), the Fp12 inverse,
     cyclotomic square and slot maps at 13,500 rows and at N = 1.
     These rows are summed in the JSON line. The Fp inverse also runs at
     N in {1, 5, 21, 128, 129} and on edge inputs (0, 1, p - 1, R mod p,
     every power of two), the Fp12 product at N in {5, 21}, and more
     kernels at more shapes: the fixed-base ladder at W in {1, 16, 17, 64}
     x N in {1, 90, 270, 900} and on crafted tables; the reduce on crafted
     chains (every branch of the complete add) at R in {1, 2, 3, 10} and
     at (R, N) in {(1, 90), (10, 13)}; the batched add at the cluster
     survey's other shapes (810 and 13,500 rows) and on the reduce's
     crafted pairs at R = 2; the Fp12 inverse on crafted rows (0, 1, a
     Miller output, a seeded value, b = 0, a = 0), each alone and tiled to
     13,500 rows; the Fp2 inverse on crafted rows (0, 1, (a, 0), (0, b),
     -1 - i, the stored limbs (p - 1, p - 1), seeded values), all in one
     launch and tiled to 13,500 rows; the cyclotomic square on crafted rows
     (0, 1, the six unit slots w^k, a GPhi12 member, seeded values outside
     GPhi12), each alone and tiled to 13,500 rows; the slot maps on
     crafted rows at N in {1, 5, 7}; the
     Miller loop at N = 1 and 1,000; the variable-base ladder on crafted
     scalars at W in {1, 2, 16, 64} and at N in {1, 5, 21}; the G2 ladder
     on crafted scalars and at N in {1, 5, 21}; the windowed GT power on
     crafted values and exponents at n_bits in {1, 2, 3, 4, 63, 64, 128,
     256} with and without cyc and at N in {1, 5, 21} (these partly filled
     blocks, and the Fp12 product's, the 8-way product's and the Miller
     loop's smaller N, each a prefix of a main shape's rows, against the
     first N rows of that shape's one plain run; the fixed-base ladder's N
     against one run at 900 for each W; the crafted rows of the Fp12
     inverse and power, alone and tiled, against one run of those rows;
     the variable-base ladder's 64-window main shapes and crafted rows
     against one plain run over all their rows, the Fp inverse's cluster
     shapes against one run at 13,500);
     the Fp12 power on
     crafted rows (exponents 0, 1, 2^n_bits - 1, bits only at or above
     n_bits; 1, the unit slots w^j, a GPhi12 member, a value outside it)
     at n_bits in {1, 48, 63, 256}, in one launch and tiled to 13,500
     rows; the 8-way product at the joint check's fold shapes and at N in
     {5, 21}. These are checked and timed the same way but left out of
     the JSON line's sums.
  3. Run the flagship encrypted logistic-regression survey at the full
     Pima width (10 DPs x 768 records, d=8, K=2, 450 GD steps, 3 servers,
     discrete-log table of +-10000): with every launch count set to 0 just
     before, read just after. All 90 decrypted sums must equal the clear
     sums and be found; the weights must match GD run by the port on the
     CPU from the same sums.
  4. Print the survey's wall time (median of timed runs after a warm-up).
  5. Run the proofs-on data collection at the same width (10 DPs x 90
     values shifted by 16^5/2, ranges (16, 5), 3 servers: 13,500 digit
     proofs) through `service.collect_with_range_proofs`, with the launch
     counts set to 0 just before and read just after. Check (a) the D
     equation of every value with the G1 kernels, (b) every challenge
     recomputed on the host from the serialized payload bytes, (c) the
     pairing equation of sampled digit proofs by the host oracle, read from
     the payload bytes, and (d) that (c) rejects a tampered Zv. Print the
     phase's wall time (median of warm runs) and its split by stage.
  6. Run the verifying node's joint check of the ten phase-5 payloads
     through `service.verify_collected_range_proofs`, counted as above: all
     ten accepted; with one Zv byte of one DP changed, only that DP
     rejected. Run the per-value check (one pairing per digit proof) once
     on the concatenated payloads, counted too: all 900 values accepted,
     and on the tampered bytes only the tampered value rejected. Print the
     joint check's wall time (median of warm runs), its split by stage and
     the peak device memory.
  7. Run the proofs-on survey of bench.py:_proofs_on_cluster through
     `LocalCluster.run_survey` (3 CNs, 10 DPs, 3 VNs, seed 4, log_reg at
     the Pima width, ranges (16, 5), thresholds 1.0), counted as above: an
     audit block of 3 VNs x 16 proofs, every entry BM_TRUE; the row
     counts of every kernel's launches printed (the reduce's as (R, N)),
     those of the reduce, the Fp and Fp2 inverses, the Fp12 product, the
     cyclotomic square and the slot maps equal to CLUSTER_ROWS; all 90
     decrypted values exact and found; the weights within 1e-3 of GD on
     the CPU; the same transcript digest from a second run with the same
     seed (verification caches cleared); a key-switch payload from a VN's
     store accepted, and rejected with one zx limb changed. Print the wall
     time of the second, warm run, its phase timers and its time in
     Schnorr signing and checking.
  8. Run the obfuscated max of the reference's minmax.toml (first run:
     1,000 buckets, 64 rows a DP, 5 DPs, 3 CNs, 3 VNs, ranges (2, 1),
     thresholds 1.0) through `LocalCluster.run_survey`, counted as above:
     the decoded max equal to the clear max and to the same survey's
     without obfuscation; an audit block of 3 VNs x 14 proofs, every entry
     BM_TRUE; the row counts of every kernel's launches printed; an
     obfuscation payload with one z limb changed recorded BM_FALSE for its
     envelope only; `schnorr.verify_batch` equal to host `verify` on every
     signed envelope of the survey and on nine forgeries. Print the wall
     time (one warm run after the first), the phase timers,
     ObfuscationPhase and VerifyObfuscation among them, and the time in
     Schnorr signing and checking.
  9. Run the noised sum (DRO): the proofs-on rows of the reference's
     simul/runfiles/scaling.toml:45-60 (`sum` over [0, 15], 5 DPs x 64
     rows, 3 CNs, 3 VNs, ranges (4, 6), thresholds 1.0) with the DRO
     parameters of simul/runner.py:133-136 and a 10,000-value noise list
     (the TIFS diffPri.py's first non-zero size, SURVEY.md:434), through
     `LocalCluster.run_survey`, counted as above: (a) with fresh
     precomputation, a first run, then a same-seed run with an equal
     transcript, timed as the warm run; (b) after `prewarm_dro` for one
     survey, one run (the cluster warm; one prewarmed run, not two, to
     keep the script in its time limit), the precompute
     counter flat and every precompute file deleted; (c) once through a
     `CryptoPool` filled by `replenish.refill_to`, whose slabs the survey
     consumes. Each run: the final shuffled noise list, decrypted with the
     CNs' secrets on the card, a permutation of the clear list; the answer
     equal to the clear sum plus the noise at index 0; an audit block of 3
     VNs x 14 proofs (3 shuffle proofs a VN), every entry BM_TRUE. Exact
     launch counts, the reduce's rows of the shuffle proofs' sums; a
     shuffle proof with one z changed BM_FALSE for its envelope only; the
     sums' two reduces timed against one reduce over all rows and a tree
     of batched adds; one shuffle proof and its check timed alone. Print
     the wall times, the phase timers (DROPhase and VerifyShuffle among
     them), Schnorr CPU time and the host time of the shuffle proofs'
     scalar chains and hashes. Then time
     `dro.dro_pipeline` alone at 100,000 values over 3 servers, fresh and
     from a pool, each output decrypted to a permutation of the clear
     list.
  10a. Run a grouped survey: frequency_count over [0, 15] on the
     proofs-on row of simul/runfiles/scaling.toml:45-52 (5 DPs, 3 CNs, 3
     VNs, ranges (4, 6)) at its largest records row (8,192 rows a DP), each
     row in one of tests/test_groupby.py's 6 groups (96 values a DP, 8,640
     digit proofs), through `LocalCluster.run_survey`, counted as above:
     every group's histogram equal to its clear counts, an all-BM_TRUE
     block, the same transcript from a second run. Print the wall times.
  10b. Run phase 7's survey at cutting factor 4 (360 values a DP, 54,000
     digit proofs), counted: the four replicas decrypt equal, the first
     equal to the clear sums, the weights within 1e-3 of CPU GD, an
     all-BM_TRUE block. Print its wall time (the cluster's first survey,
     its warm-up in it).
  11. Run four of phase 7's surveys (survey seeds 0-3) through
     `server.SurveyServer(max_batch=4, pipeline=True)`: the first submit
     takes the compile lane (the warm-up registry on the drain thread,
     its seconds and `CompileStats` table printed), the other three the
     fast lane; the four run as one group, held, flushed by one
     `VNGroup.flush_cross_survey` (one `Pipeline.flush.*` span over the
     four ids) and finalized on the `server-verify` thread, counted: four
     all-BM_TRUE blocks, every survey's decrypted statistics equal to the
     clear sums and its weights within 1e-3 of CPU GD, one RLC check of
     54,000 digit proofs in the flush, every kernel launched an entry of
     the registry for the batch's profile. Then the four surveys' 40 range
     payloads from a VN's store, re-signed and held again at that VN with
     one Zv byte of DP 3's payload of the third survey changed, flushed as
     one cross batch: BM_FALSE for that envelope only, every other BM_TRUE.
     Print the flush's time beside the surveys' VerifyRange.
  12. Run the stream of scripts/bench_stream.py's headline through
     `service.streaming.StreamEngine` (2 CNs, 2 DPs, 2 VNs, frequency_count
     over [0, 15], ranges (16, 4), 12,500-row panes, a window of 8, a
     sixth of the headline's 48, for the script's time limit):
     fill the window, advance by 1 pane and by 2, each counted: the result
     equal to the clear counts, the delta window's bytes equal to a
     from-scratch fold of its panes, a 1-pane advance making and checking
     one pane proof a DP and shipping only the CNs' aggregation proofs;
     a from-scratch control on a cold stream id fed every row (the same
     result, window bytes and decrypted values); an engine restarted on
     the same stream id with the pane ProofDB (every blob reused, the
     advance's bytes and transcript and every pane's transcript
     reproduced); every block all BM_TRUE. Print the pane seal, advance
     and scratch times and their ratio.
  13. The standing server and its load, on scripts/bench_load.py's
     transcript cluster (2 CNs, 2 DPs, 2 VNs, seed 13, two values a DP):
     (a) proofs-on sums s0, s1 (ranges (4, 2)) and s2 ((4, 3)) through
     `SurveyServer` at one and at two verify workers, each on a fresh
     cluster after `prewarm(s0)`: all three in the fast lane (s2's shape
     names no entry that s0's warm-up left cold: the same base u), s0 and
     s1 flushed together, s2 alone, equal transcripts across the worker
     counts, every result the clear sum, all-BM_TRUE blocks, the pipeline
     overlap and the server's spans printed (encode, payload wait, flush,
     verify), no cold event (library load or table build) off the drain
     thread and no table built inside a survey, exact launches; (b) a
     closed loop of 16 proofs-off `sum` and `mean` surveys from two
     tenants through `LoadGen` (concurrency 4): every offer completed or rejected with a
     type, none lost, every answer the clear one, exact launches, the
     throughput and latency percentiles printed; (c) `precompile(BENCH)`
     on the warm process: every library loaded, every kernel entry
     executed, no error.
  14. The in-process fault plane (a plan installed for the sub-phase
     alone and cleared after it, whatever happens; 14a and 14c run after
     phase 12, 14b after 13): (a) phase 7's survey
     on phases 10b and 11's cluster with dp9 and vn2 killed,
     min_dp_quorum 9 and vn_quorum 2/3, counted: responders dp0..dp8,
     absent dp9, the decrypted aggregate equal to the nine responders'
     clear sums, the weights within 1e-3 of CPU GD on them, one RLC check
     of 12,150 digit proofs, a block of vn0's and vn1's entries only, all
     BM_TRUE, every phase entered once and no resume; a query asking for
     all ten DPs refused with the quorum error; its phase timers beside
     phase 7's; (b) a proofs-off sum on phase 13's transcript cluster
     through `SurveyServer`, its checkpoints in a durable store, with a
     one-shot refused connect to dp1: the first dispatch fails its
     quorum, the resume lane re-probes and re-enters once, the result
     equals an undisturbed run's over dp0 and dp1, one resume, the
     record read back from the store, exact launches; (c) the encrypted
     prediction of 768 Pima-shaped records of 8 integer features under
     the querier's key with phase 7's weights, counted: every decrypted
     margin equal to the integer formula and found, the probabilities
     within 0.02 of the clear ones, the G1 kernels' calls kept with
     phases 10-12's.
  15. The control plane over TCP. (a) Phase 7's survey through 16
     `service.node.DrynxNode`s on 127.0.0.1 in this process (3 CNs, 10
     DPs holding phase 7's Pima shards, 3 VNs), driven by a
     `RemoteClient`: each DP encrypts and proves its own 90 values, the
     root CN folds them up the tree overlay (fanout 4) or the star; a
     cold survey, a warm one over the tree, a warm one over the star,
     each with the decrypted aggregate equal to phase 7's integers, the
     weights within 1e-3 of phase 7's, a block of 3 x 14 entries all
     BM_TRUE; the warm runs' launches and rows equal to
     `tcp_survey_launches` for the roster; first, the card's widen of
     every narrowed wire dtype pair equal to the host's. Printed: the
     wall times beside phase 7's, the root's received bytes, the wire
     timers' host-glue seconds (the wire's card side is not timed), the
     cold run's cold events by thread.
     (b) The scenarios of test/client_run-survey and
     test/client_run-survey-proofs (CLI_SCENARIOS, both at once, their
     servers started before (a) so that they boot while it runs), every
     node a `python -m drynx_tpu_torch.cmd.server run` process on the
     card (its listening line naming the CUDA device), the roster and
     survey built by piping `python -m drynx_tpu_torch.cmd.client`: sum
     75; sum 15 with a clean bitmap; every server alive until killed.
  16. The PR 19 slice (16a-c run after 14b, before 15a; 16d's scenarios
     and 15b's servers start with 16a, 16d's LR survey waits until 15a
     has ended, and 16d is awaited after 15b). (a) Encrypted LR on the Pima (768 x
     8), PCS (1,500 x 6) and SPECTF (267 x 44, V = 2,070) shapes of
     `data.datasets.generate(name, seed=3)`, written and read back
     through `write_csv`/`load_csv`, through `flagship.build_pipeline`
     (5 DPs, 3 servers, dlog +-40,000, tests/test_lr_datasets.py's
     parameters), counted: the aggregate the clear sum, every value
     found, the weights within 1e-3 of CPU GD, accuracy and AUC >= 0.6
     and accuracy >= the clear exact-loss GD's - 0.1; then
     `create_random_good_test_data`'s five payloads against a cluster of
     phase 7's configuration, each accepted by the port's verifier for
     its type, the range payload with a Zv byte changed rejected.
     (b) `simul.runner.run_file` on the port's drynx.toml (three sums)
     and minmax.toml (the max over 1,000 and 10,000 buckets), each row
     counted: the clear answer from the row's default_rng(seed) draws,
     every DP a responder, a clean block of VNs x (DPs + 2 CNs) entries;
     the 10,000-bucket row's encryption in plan_tiles(10,000)'s 3 tiles
     and its commit stage in proof_tile_shards(50,000, 4,096) = 13
     dispatches, by the launches' rows; the CSV read back and timedata's
     table printed; one DP's 10,000 values created tiled and monolithic
     from the same draws, byte-equal, with both peak memories. (c) On a
     mesh of one card: phase 5's collection with its commit over 4
     shards, byte-equal, launches one creation's plus 3 commits'; phase
     6's payloads through the sharded verifier (plane forced to 4), the
     tampered DP rejected alone, no fallback; rlc_total_shards and
     rlc_total_sharded byte-equal to rlc_total_single; `dryrun_step`
     over 10 shards (the ring) equal to phase 3's sums and weights, its
     launches by formula; the butterfly over 8 shards of phase 3's
     ciphertexts equal to their sequential sum; the scalar product over
     3 shards equal to the host's; obfuscation keeping zeros; phase 9's
     DRO slabs' shard spans. (d) The port's scenarios
     client_network-new, server_conf-and-run and
     client_run-lr-survey-proofs as bash processes with every server on
     the card: each OK, the LR weights within 1e-9 of the clear-text
     twin with a clean bitmap.
  17. The static analyzer's runtime cross-checks
     (`drynx_tpu_torch.analysis.crosscheck`), five processes at once after
     16d, each a fresh interpreter whose first import is drynx_tpu_torch:
     (a) under DRYNX_LOCK_TRACE=1, a 2-worker pipelined `SurveyServer`
     over LocalCluster(1 CN, 2 DPs, 0 VNs, seed 23) takes a burst of 8
     proofs-off sums (queue 4, shedding at half): something shed and
     something completed, the observed named-lock edges within the static
     lock-order graph of drynx_tpu_torch/, B1-B5 launched; (b) under
     DRYNX_DET_TRACE=1, twice: a proofs-on sum (ranges (4, 2)) through
     `SurveyServer(max_batch=1)` over LocalCluster(2 CNs, 2 DPs, 2 VNs,
     seed 13), its transcript, a ProofDB pane put and an epsilon charge:
     transcript, journal and pane keys written, laundered keys seen, no
     key's write multiset differing between the runs but the skipchain's
     blocks, the runs' launches and rows equal; (c) under
     DRYNX_PROTO_TRACE=1, three slab refills on the card, consume_dro(10),
     a second store over the root, the checkpoint's cycles and a ConnPool
     echo conversation: no lifecycle the automata reject, at least 3
     kinds, 20 events, 3 slabs, 8 conns and 2 checkpoints, B1 launched;
     (d) `python -m drynx_tpu_torch.analysis` over the shipped tree exits
     0. Each one's seconds are printed beside the card's name and power
     limit.
  Phases 7-12 warm their clusters' kernels in their first proofs-on
  survey (`LocalCluster._warm_kernels`), whose PrecompileTraceExec
  is printed beside its time; the warm-up's launches are its own
  (`cuda_build.uncounted`), so every count above is the survey's.
  Phases 10-12 and 14c keep each kernel's largest call of each phase
  (KeptCalls, all 14 kernels of the survey paths; never a warm-up call)
  and hold them, after 14c, byte for byte against the plain versions. Last, the kernels' times, launch counts
  and bounds as one JSON line, the card's name and power limit, and the
  contract line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --only 10a,10b,11,12,13,14a,14b,14c,15a,15b,16a,16b,16c,16d,17

builds the kernels and runs only the named phases of 10-17 (no JSON line;
16c then makes phases 3 and 5's survey, signatures and payloads itself;
14c then scores with GD's weights from the clear sums, and holds its kept
calls itself when no phase of 10-12 runs; 15a holds its weights to GD's
from the clear sums).

It imports nothing of JAX and nothing of the drynx_tpu package.
"""
import collections
import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Pima width of the reference's exec benchmark (bench.py:bench_exec)
NUM_DPS, N_SERVERS, N_RECORDS, D, ITERS, DLOG_LIMIT = 10, 3, 768, 8, 450, 10000
TIMED_RUNS = 5
KERNEL_REPS = 10
# launches of one survey: encrypt rB, |m|B, rP and key switch rB, rQ;
# key switch xK and decrypt; aggregate and the two key-switch sums;
# encrypt, key switch and its finish, decrypt; one normalize
VERIFY_KERNELS = ("miller", "f12_inv", "f12_csqr", "f12_slotmul", "f12_wpow",
                  "f12_pow")   # f12_pow: no path of the port runs it
EXPECTED_LAUNCHES = {"fixed_base_mul": 5, "scalar_mul": 2, "point_reduce": 3,
                     "point_add": 4, "fp_inv": 1, "f2_inv": 0,
                     "g2_scalar_mul": 0, "f12_mul": 0, "f12_mulreduce8": 0,
                     **dict.fromkeys(VERIFY_KERNELS, 0)}
# the proofs-on survey's ranges (bench.py:RANGES, reference simulation
# preset 18) and its data collection's launches: encrypt rB, |m|B, rP and
# D's two fixed-base products; encrypt's add and D's; normalize of the
# ciphertexts and of D, of the blinded signatures V; the ladder of V; two
# passes each of the digit power and of gtB^t; the product a
U, L = 16, 5
SIG_SEED, PROOF_SEED = 5, 7
PROOF_RUNS = 3
CHECK_SAMPLES = [(dp, i, val, j) for dp, val, j in
                 ((0, 0, 0), (0, 45, 2), (NUM_DPS - 1, 17, 1),
                  (NUM_DPS - 1, 89, 4)) for i in range(N_SERVERS)]
EXPECTED_LAUNCHES_PROOFS = {"fixed_base_mul": 5, "scalar_mul": 0,
                            "point_reduce": 0, "point_add": 2, "fp_inv": 2,
                            "f2_inv": 1, "g2_scalar_mul": 1, "f12_mul": 1,
                            "f12_mulreduce8": 4,
                            **dict.fromkeys(VERIFY_KERNELS, 0)}
# the joint check's launches: the D equation (c C2, two fixed-base products,
# two adds), the GPhi12 gate (two frob2, one product), the order gate (frob1,
# a 128-bit power), gtB^(sum r Zv) (two passes); c y and -Zphi B, their sum,
# the weighting by r, both normalizations, the Miller loop, a^r (a 63-bit
# power); the folds of the Miller values and of a^r (five passes each, 13,500
# padded to 8^5); one final exponentiation (an inverse, 14 slot
# multiplications, three powers by u, four cyclotomic squares, 15 products);
# the total's two products
EXPECTED_LAUNCHES_VERIFY = {"fixed_base_mul": 3, "scalar_mul": 3,
                            "point_reduce": 0, "point_add": 3, "fp_inv": 1,
                            "f2_inv": 1, "g2_scalar_mul": 0, "f12_mul": 18,
                            "f12_mulreduce8": 12, "miller": 1, "f12_inv": 1,
                            "f12_csqr": 4, "f12_slotmul": 17, "f12_wpow": 5,
                            "f12_pow": 0}
# the per-value check's launches: the D equation as above; c y, -Zphi B and
# their sum; both normalizations; one pairing of every digit proof (the
# Miller loop and the final exponentiation above) times gtB^Zv (two passes)
EXPECTED_LAUNCHES_PER_VALUE = {"fixed_base_mul": 3, "scalar_mul": 2,
                               "point_reduce": 0, "point_add": 3, "fp_inv": 1,
                               "f2_inv": 1, "g2_scalar_mul": 0, "f12_mul": 16,
                               "f12_mulreduce8": 2, "miller": 1, "f12_inv": 1,
                               "f12_csqr": 4, "f12_slotmul": 14, "f12_wpow": 3,
                               "f12_pow": 0}
TAMPER_DP = 3
# the proofs-on LocalCluster survey (bench.py:_proofs_on_cluster): phase 5's
# creation launches (encryption: three fixed-base products and an add; the
# range proofs: D's two fixed-base products and add, two normalizations, the
# G2 ladder, its normalization, four 8-way products and a product), the
# canonical aggregate (a reduce and a normalization), the key switch (two
# fixed-base products, a ladder, an add, two reduces, the finish's add, and
# the signed-offset correction's fixed-base product and add), the key-switch
# proof (two fixed-base products, a ladder, an add, one normalization of its
# transcript), decryption (a ladder, an add, a normalization); then the VNs'
# checks, each payload once (the VNs share one verification cache): the
# joint range check as EXPECTED_LAUNCHES_VERIFY, the aggregation proof (a
# reduce), the key-switch proofs (two fixed-base products, one ladder over
# c U, zx K, c W and c Y, two adds, one normalization)
N_VNS, CLUSTER_SEED, SURVEY_SEED = 3, 4, 0
SIGNED_OFFSET_LAUNCHES = {"fixed_base_mul": 1, "point_add": 1}
EXPECTED_LAUNCHES_CLUSTER = {"fixed_base_mul": 15, "scalar_mul": 7,
                             "point_reduce": 4, "point_add": 12, "fp_inv": 7,
                             "f2_inv": 2, "g2_scalar_mul": 1, "f12_mul": 19,
                             "f12_mulreduce8": 16, "miller": 1, "f12_inv": 1,
                             "f12_csqr": 4, "f12_slotmul": 17, "f12_wpow": 5,
                             "f12_pow": 0}
# the row counts of the cluster survey's B3, B4, B7, B10, B11 and B14
# launches, {rows: launches} (B3's rows (R, N)), as phase 7 records them;
# phase 2 times the kernels at each. B3: the canonical aggregate of the 10 DPs'
# ciphertexts and the VN's aggregation-proof check (R = 10 over 2 x 90
# points), the key switch's two sums over the 3 CNs; B4: the collection's
# ciphertexts and D, the canonical aggregate, the key-switch proof's
# transcript, decryption, the joint check's RLC points, the VN's
# key-switch check; B7: the collection's a = gt1 gt2 and the joint check's
# GPhi12 gate, then its final exponentiation (15) and total (2); B11: the
# joint check's GPhi12 gate (two frob2) and order gate (frob1), then its
# final exponentiation (14); B10: the final exponentiation's four
# cyclotomic squares; B14: the normalizations of the blinded signatures V,
# in the collection and in the joint check
CLUSTER_ROWS = {"point_reduce": {(10, 180): 2, (3, 90): 2},
                "fp_inv": {1800: 1, 900: 1, 180: 1, 1444: 2, 90: 1,
                           13_500: 1},
                "f2_inv": {13_500: 2},
                "f12_mul": {13_500: 2, 1: 17},
                "f12_csqr": {1: 4},
                "f12_slotmul": {13_500: 3, 1: 14}}

# the obfuscated max of the reference's simul/runfiles/minmax.toml, first
# run (the TIFS "max w/ obf" setting, SURVEY.md:428): 1,000 buckets over
# [0, 999], 64 rows a DP from a seed, 5 DPs, 3 CNs, 3 VNs, proofs with
# ranges (2, 1), discrete-log table of +-25,000, obfuscation on,
# thresholds 1.0: 5,000 range-proofed values (15,000 digit proofs) and 3
# obfuscation proofs of 1,000 ciphertexts, 14 signed envelopes
MAX_DPS, MAX_ROWS, MAX_QMAX, MAX_DLOG, MAX_DATA_SEED = 5, 64, 999, 25_000, 8
# minmax.toml's second row: 10,000 buckets
MINMAX_BIG = 10_000
# its launches: phase 7's without the signed offset's correction (the
# joint range check's folds again five passes, over 15,000 digit proofs),
# and for each CN's obfuscation proof a ladder over s K, s C, w K, w C and
# a normalization of its transcript, then the VNs' check of it: a ladder
# over z K, z C, c K', c C', an add and a normalization
OBFUSCATION_LAUNCHES = {"scalar_mul": 2, "point_add": 1, "fp_inv": 2}
EXPECTED_LAUNCHES_MAX = {
    k: v - SIGNED_OFFSET_LAUNCHES.get(k, 0)
    + N_SERVERS * OBFUSCATION_LAUNCHES.get(k, 0)
    for k, v in EXPECTED_LAUNCHES_CLUSTER.items()}

# the noised sum: the proofs-on rows of the reference's
# simul/runfiles/scaling.toml:45-60 (5 DPs, 3 CNs, 3 VNs, ranges (4, 6))
# with 64 rows a DP drawn as simul/runner.py draws them (integers in
# [0, 15) from a seed), `sum` over [0, 15], thresholds 1.0, dlog table
# +-25,000, and the DRO parameters of simul/runner.py:133-136 at the TIFS
# diffPri.py's first non-zero noise-list size (SURVEY.md:434); LocalCluster
# seed 4, survey seed 0. Then the noise pipeline alone at the TIFS's
# second size.
NOISE_DPS, NOISE_ROWS, NOISE_QMAX, NOISE_DLOG, NOISE_DATA_SEED = (
    5, 64, 15, 25_000, 9)
NOISE_RANGES = (4, 6)
NOISE_SIZE, NOISE_SCALE_SIZE = 10_000, 100_000
NOISE_DIFFP = {"lap_mean": 0.0, "lap_scale": 2.0, "quanta": 1.0,
               "scale": 1.0, "limit": 8.0}
NOISE_POOL_SEED, NOISE_SCALE_SEED = 21, 22
# its audit block: a VN gets 5 range proofs and 3 each of the shuffle,
# aggregation and key-switch proofs
NOISE_BITMAP_ENTRIES = N_VNS * (NOISE_DPS + 3 * N_SERVERS)
# its launches: phase 7's without the signed offset's correction, the joint
# range check's folds at ceil(log8(digit proofs)) passes, then the DRO
# phase: the noise's encryption (three fixed-base products and an add) and
# the noise's add to the result; per CN and noise slab, with fresh
# precomputation, r B and r P, and the shuffle's add; per CN its shuffle
# proof and the VNs' check of it (each a fixed-base launch, one ladder,
# one add, two reduces and three normalizations)
# the rows at each end of a row-wise kernel's largest call in the noised
# sum that phase 9 holds against the plain version (a block is at most 128
# rows)
KEPT_EDGE = 512
DRO_LAUNCHES = {"fixed_base_mul": 3, "point_add": 2}
DRO_LAUNCHES_SLAB = {"point_add": 1}
DRO_LAUNCHES_FRESH_SLAB = {"fixed_base_mul": 2}
DRO_LAUNCHES_CN = {"fixed_base_mul": 2, "scalar_mul": 2, "point_add": 2,
                   "point_reduce": 4, "fp_inv": 6}


# the grouped survey: the proofs-on row of simul/runfiles/scaling.toml:45-52
# (5 DPs, 3 CNs, 3 VNs, ranges (4, 6)) with the largest records row of
# :74-78 (8,192 rows a DP, drawn as simul/runner.py:130 draws them, seed 9),
# frequency_count over [0, 15], each row's group drawn uniformly from
# tests/test_groupby.py:17's GROUP_BY (6 groups): V = 96 a DP, 8,640 digit
# proofs; dlog +-25,000, LocalCluster seed 4, survey seed 0
GROUP_BY = [[0, 1], [10, 20, 30]]
GROUP_ROWS = 8192
# the cut survey: phase 7's at cutting factor 4 (V = 360 a DP, 54,000 digit
# proofs); the held batch: four of phase 7's surveys, survey seeds 0-3
# (SurveyServer's default max_batch, drynx_tpu/server/scheduler.py:130), one
# DP's payload of the third with one Zv byte changed in the second batch
CUT, HELD = 4, 4
# the stream: the headline of scripts/bench_stream.py:241-258, 2 CNs, 2 DPs,
# 2 VNs, LocalCluster seed 7, dlog +-90,000, frequency_count over [0, 15],
# ranges (16, 4), 12,500-row panes, a window of 8 (100,000 rows a DP; the
# headline's 48 cut to a sixth to keep the script in its time limit),
# rows from default_rng(3), engine seed 21;
# filled, then advanced by 1 pane and by 2 (11 panes)
STREAM = dict(n_cns=2, n_dps=2, n_vns=2, seed=7, dlog=90_000, V=16,
              ranges=(16, 4), pw=12_500, w=8, data_seed=3, engine_seed=21)
# the server and its load: the cluster of scripts/bench_load.py:389-430
# (child_transcripts): 2 CNs, 2 DPs, 2 VNs, seed 13, dlog +-4,000, two
# values a DP from default_rng(5) in [0, 4); proofs-on `sum` surveys over
# [0, 15], s0 and s1 with ranges (4, 2), s2 with (4, 3); then a closed
# loop of proofs-off `sum` and `mean` surveys from two tenants
LOAD = dict(n_cns=2, n_dps=2, n_vns=2, seed=13, dlog=4000, data_seed=5,
            rows=2, qmax=15, ranges=((4, 2), (4, 2), (4, 3)),
            concurrency=4, total=16)
# the degraded survey: phase 7's with dp9 and vn2 killed by a fault plan,
# over the nine responders (min_dp_quorum 9: 12,150 digit proofs) with a
# block from two of the three VNs (vn_quorum 2/3); a second query asking
# for all ten DPs is refused
DEGRADED_KILLED = ("dp9", "vn2")
DEGRADED_QUORUM, DEGRADED_VN_QUORUM = NUM_DPS - 1, 2 / 3
# the encrypted prediction: 768 records of Pima's 8 features rounded to
# integers, encrypted under the querier's key (encryption seed 17), scored
# with phase 7's weights at fixed-point precision 100; its launches: the
# features' products (one ladder), their sum (one reduce), w0'B (a
# fixed-base product) and its add, then the decryption (a ladder, an add,
# a normalization)
PREDICT_RECORDS, PREDICT_PRECISION, PREDICT_SEED = 768, 100.0, 17
PREDICT_LAUNCHES = {"fixed_base_mul": 1, "scalar_mul": 2, "point_reduce": 1,
                    "point_add": 2, "fp_inv": 1}
# a proofs-off cluster survey's launches: encryption (three fixed-base
# products, an add), the canonical aggregate (a reduce, a normalization),
# the key switch (two fixed-base products, a ladder, an add, two reduces,
# the finish's add) and decryption (a ladder, an add, a normalization)
PROOFS_OFF_LAUNCHES = {**EXPECTED_LAUNCHES, "fp_inv": 2}
# an advance's survey tail: the VNs' check of the CNs' aggregation proof (a
# reduce over the window's folds), the key switch (two fixed-base products,
# a ladder, an add, two reduces over the 2 CNs, the finish's add) and
# decryption (a ladder, an add, a normalization)
ADVANCE_AGG = {"point_reduce": 1}
ADVANCE_TAIL = {"fixed_base_mul": 2, "scalar_mul": 2, "point_add": 3,
                "point_reduce": 2, "fp_inv": 1}
# a pane's seal: encryption (three fixed-base products, an add) and the fold
# of the DPs' ciphertexts (a reduce, a normalization); its range proofs:
# phase 5's creation without the encryption
PANE_SEAL = {"fixed_base_mul": 3, "point_add": 1, "point_reduce": 1,
             "fp_inv": 1}
PANE_PROOF = {"fixed_base_mul": 2, "point_add": 1, "fp_inv": 2, "f2_inv": 1,
              "g2_scalar_mul": 1, "f12_mul": 1, "f12_mulreduce8": 4}


def fold_passes(n):
    """ceil(log8(n)), at least 1: the 8-way product's passes over n."""
    passes = 1
    while 8 ** passes < n:
        passes += 1
    return passes


def verify_launches(digit_proofs):
    """One RLC check (the joint check's kernels) over `digit_proofs` digit
    proofs: gtB^S's two passes and the two folds' passes."""
    want = dict(EXPECTED_LAUNCHES_VERIFY)
    want["f12_mulreduce8"] = 2 + 2 * fold_passes(digit_proofs)
    return want


def add_launches(want, launches, times=1):
    for k, v in launches.items():
        want[k] = want.get(k, 0) + v * times
    return want


def survey_launches(digit_proofs, signed_offset):
    """A proofs-on cluster survey's launches (phase 7's) with a joint range
    check of `digit_proofs`; without the signed offset's correction for an
    op other than log_reg."""
    want = {k: v - (0 if signed_offset else SIGNED_OFFSET_LAUNCHES.get(k, 0))
            for k, v in EXPECTED_LAUNCHES_CLUSTER.items()}
    # phase 7's 13,500 digit proofs fold in five passes
    return add_launches(want, {"f12_mulreduce8": 2 * (
        fold_passes(digit_proofs) - 5)})


def tcp_survey_launches(n_cns, n_dps, n_vns, V, digits, topology, fanout,
                        signed_offset):
    """A proofs-on survey's kernel launches over the TCP nodes (phase 15a),
    derived from the roster: each DP's encryption and range proofs of its V
    values (`digits` digits a value, one (u, l) spec), each relay's fold of
    its subtree and its parent's check of the hop's aggregation proof (the
    tree overlay of `fanout`, or the star), the root's fold, each CN's key
    switch and its proof, the root's sums (and the signed offset's
    correction), each VN's checks of the aggregation proof, of the CNs'
    key-switch proofs (one each) and of the DPs' range payloads (one joint
    check), and the querier's decryption. Returns ({kernel: launches},
    Counter({(kernel, rows): launches}), with a reduce's rows (R, N))."""
    import collections

    from drynx_tpu_torch.service import topology as topo

    rows = collections.Counter()

    def add(kernel, n_rows, times=1):
        rows[(kernel, n_rows)] += times

    ns, l = n_cns, digits
    nv = ns * V * l                       # one DP's digit proofs x CNs
    for _ in range(n_dps):
        # encryption: r B, |m| B, r P, and the add
        add("fixed_base_mul", V, 3)
        add("point_add", V)
        # the range proofs: D (two fixed-base products and an add), the
        # blinded signatures (the G2 ladder), the digit powers and gtB^t
        # (two passes of the 8-way product each), their product, and the
        # transcript's normalizations (the ciphertexts, D, the signatures)
        add("fixed_base_mul", V, 2)
        add("point_add", V)
        add("g2_scalar_mul", nv)
        for n in (nv, V * l):
            add("f12_mulreduce8", 8 * n)
            add("f12_mulreduce8", n)
        add("f12_mul", nv)
        add("fp_inv", 2 * V)
        add("fp_inv", V)
        add("f2_inv", nv)
    if topology == "tree" and n_dps > 1:
        n_roots = len(topo.roots(n_dps, fanout))
        for i in range(n_dps):
            k = 1 + len(topo.children(i, n_dps, fanout))
            if k > 1:
                # the relay's fold (a reduce, a normalization) and its
                # parent's check of the hop's aggregation proof (a reduce)
                add("point_reduce", (k, 2 * V), 2)
                add("fp_inv", 2 * V)
    else:
        n_roots = n_dps
    # the root's canonical fold, and each VN's check of its proof
    if n_roots > 1:
        add("point_reduce", (n_roots, 2 * V))
    add("fp_inv", 2 * V)
    add("point_reduce", (n_roots, 2 * V), n_vns)
    for _ in range(n_cns):
        # U = r B, r Q, x K and W = r Q - x K; the proof's r B, w B, x B in
        # one launch, w Q, w K, its add and its transcript's normalization
        add("fixed_base_mul", V, 3)
        add("fixed_base_mul", 2 * V + 1)
        add("scalar_mul", V, 2)
        add("point_add", V, 2)
        add("fp_inv", 6 * V + 2)
        # each VN's check: z B (two scalars a row), z Q, one ladder over
        # c U, z K, c W and c Y, two adds, the transcript's normalization
        add("fixed_base_mul", 2 * V, n_vns)
        add("fixed_base_mul", V, n_vns)
        add("scalar_mul", 4 * V, n_vns)
        add("point_add", 3 * V, n_vns)
        add("point_add", V, n_vns)
        add("fp_inv", 6 * V + 2, n_vns)
    # the root's sums of the CNs' U and W and the add to C
    add("point_add", V, 2 * (n_cns - 1) + 1)
    if signed_offset:
        add("fixed_base_mul", 1)
        add("point_add", V)
    # each VN's joint check of the DPs' payloads (verify_launches' kernels)
    vt, dg = n_dps * V, n_dps * nv
    for _ in range(n_vns):
        add("fixed_base_mul", vt, 2)
        add("fixed_base_mul", dg // ns)
        add("scalar_mul", vt)
        add("scalar_mul", ns * vt)
        add("scalar_mul", dg)
        add("point_add", vt, 2)
        add("point_add", dg)
        add("fp_inv", dg)
        add("f2_inv", dg)
        add("miller", dg)
        add("f12_mul", dg)
        add("f12_mul", 1, 17)
        add("f12_slotmul", dg, 3)
        add("f12_slotmul", 1, 14)
        add("f12_wpow", dg, 2)
        add("f12_wpow", 1, 3)
        add("f12_inv", 1)
        add("f12_csqr", 1, 4)
        add("f12_mulreduce8", 8)
        add("f12_mulreduce8", 1)
        for _fold in range(2):
            for p in range(fold_passes(dg) - 1, -1, -1):
                add("f12_mulreduce8", 8 ** p)
    # the querier's decryption: a ladder, an add, a normalization
    add("scalar_mul", V)
    add("point_add", V)
    add("fp_inv", V)
    counts = dict.fromkeys(EXPECTED_LAUNCHES_CLUSTER, 0)
    for (kernel, _n), times in rows.items():
        counts[kernel] += times
    return counts, rows


def stream_launches(sealed, proved, verified, payload_proofs, delta,
                    agg_checked=True):
    """A stream advance's launches: `sealed` panes sealed, `proved` of them
    range-proved, `verified` pane payloads of `payload_proofs` digit proofs
    checked by the VNs, then the window fold (`delta` adds and a
    normalization, or a from-scratch fold for None: a reduce and a
    normalization) and the survey tail (the aggregation check unless the
    VNs' cache holds its verdict)."""
    want = dict.fromkeys(EXPECTED_LAUNCHES_CLUSTER, 0)
    add_launches(want, PANE_SEAL, sealed)
    add_launches(want, PANE_PROOF, proved)
    add_launches(want, verify_launches(payload_proofs), verified)
    add_launches(want, {"point_reduce": 1, "fp_inv": 1} if delta is None
                 else {"point_add": delta, "fp_inv": 1})
    add_launches(want, ADVANCE_TAIL)
    return add_launches(want, ADVANCE_AGG if agg_checked else {})


def noised_sum_launches(n_cns, n_slabs, digit_proofs, fresh):
    """The noised sum's launches for n_cns CNs, n_slabs noise slabs and a
    joint range check of digit_proofs digit proofs; `fresh`: every CN's
    zero-encryptions computed in the survey."""
    want = survey_launches(digit_proofs, signed_offset=False)
    for launches, times in ((DRO_LAUNCHES, 1), (DRO_LAUNCHES_CN, n_cns),
                            (DRO_LAUNCHES_SLAB, n_cns * n_slabs),
                            (DRO_LAUNCHES_FRESH_SLAB,
                             n_cns * n_slabs if fresh else 0)):
        add_launches(want, launches, times)
    return want


# H100 SXM: 132 SMs, 64 32-bit integer multiply-adds per SM per clock,
# 3.35 TB/s device memory (NVIDIA data sheet and Hopper white paper)
SMS, IMAD_PER_CLK_SM, MEM_BYTES_PER_S = 132, 64, 3.35e12
# 32-bit multiply-adds in one 8-word CIOS Montgomery product
IMAD_PER_MONT_MUL = 256
# Montgomery products per element (counted from the algorithms)
# Jacobian add-2007-bl 11M + 5S, mixed add madd-2007-bl (the second point
# affine) 7M + 4S, double dbl-2009-l 2M + 5S. The kernels' complete add
# also computes a double and keeps it only when both points are equal,
# which this run's random data never makes them, so it is not counted.
MM_G1_ADD, MM_G1_MADD, MM_G1_DBL = 16, 11, 7


def _digits(k, n_windows):
    """The low n_windows 4-bit digits of plain 16-bit-limb scalars, LSB
    first, as (rows, n_windows)."""
    d = (k.long()[:, :, None] >> (4 * torch.arange(4, device=k.device))) & 15
    return d.reshape(k.shape[0], -1)[:, :n_windows]


def mm_fixed_base(k, n_windows):
    """Montgomery products per row, averaged over the rows, that the sum
    of the selected table entries needs for this run's scalars k: digit 0
    selects infinity and costs nothing, the first non-zero digit's entry
    is a copy, and each further one a mixed add (every table entry is
    affine, Z = 1). The kernel reads every window, adds the infinities and
    sums in a tree of complete adds; the bound counts only what these
    scalars need."""
    nonzero = (_digits(k, n_windows) != 0).sum(1)
    return float((nonzero - 1).clamp(min=0).sum()) * MM_G1_MADD / k.shape[0]


def _mm_ladder(k, n_windows, mm_dbl, mm_add):
    """Montgomery products per row, averaged over the rows, of a
    variable-base ladder for this run's scalars k: the table d*P (7
    doubles and 7 adds), then, below the highest non-zero digit, 4 doubles
    a window and an add for each non-zero digit. The kernels double from
    the top window and add at every digit, infinity or not."""
    nonzero = _digits(k, n_windows) != 0
    top = torch.where(nonzero, torch.arange(n_windows, device=k.device),
                      -1).amax(1)
    rows = top >= 0
    work = (4 * top[rows] * mm_dbl + (nonzero[rows].sum(1) - 1) * mm_add)
    return 7 * (mm_dbl + mm_add) + float(work.sum()) / k.shape[0]


def mm_scalar_mul(k, n_windows):
    """The G1 ladder's products per row for this run's scalars k."""
    return _mm_ladder(k, n_windows, MM_G1_DBL, MM_G1_ADD)


# G2 over Fp2 (3 products per Fp2 product, 2 per square): a double is
# 5 squares + 2 products = 16, an add (add-2007-bl) 5 squares + 11
# products = 43; as for G1, the complete add's masked double is not counted
MM_G2_DBL, MM_G2_ADD = 16, 43


def mm_g2_ladder(k):
    """The G2 ladder's products per row (64 windows) for this run's
    scalars k."""
    return _mm_ladder(k, 64, MM_G2_DBL, MM_G2_ADD)

MM_F12_MUL = 18 * 3             # 18 Fp2 products
MM_F12_SQR = 12 * 3             # complex method: 12 Fp2 products
MM_F12_CSQR = 9 * 2             # Granger-Scott: 9 Fp2 squares
MM_F12_SLOTMUL = 6 * 3          # 6 Fp2 products by constants
# B4, counted from csrc/fp_inv.cuh in 32-bit integer operations a row (a
# 32 x 32 -> 64-bit multiply-add, or a 64-bit shift, two): a divstep 27,
# a batch's update of (d, e) 174 and of (f, g) 124, 20 batches of 30
# divsteps, then one Montgomery product (256); the limb conversions at the
# edges, under 1 %, are left out. In Montgomery products' worth, as the
# bound takes them.
OPS_FP_INV = 20 * (30 * 27 + 174 + 124) + IMAD_PER_MONT_MUL
MM_FP_INV = OPS_FP_INV / IMAD_PER_MONT_MUL
# B14: the norm (2), the Fp inverse by safegcd, two products
MM_F2_INV = 2 + MM_FP_INV + 2
# B8, the tower inverse: the norm (2 Fp6 products = 36), the Fp6 adjugate
# (3 squares, 6 products = 24), the Fp2 inverse (its norm 2, the Fp inverse
# by safegcd, 2 products) and 3 products (9), then 2 Fp6 products (36)
MM_F12_INV = 36 + 24 + (2 + MM_FP_INV + 2) + 9 + 36


def mm_miller(ate_bits):
    """Montgomery products of one Miller loop over the bits of 6u + 2 below
    its leading one: a double step per bit (a square, 5 products, 2 by an
    Fp element, 5 more squares = 31; the Fp12 square 36; the line product
    54), an add step where the bit is set and for each of the 2 Frobenius
    corrections (4 squares, 10 products, 2 by an Fp element = 42; the line
    product 54). The bits are public: the kernel adds only where one is
    set, as the function does."""
    return (len(ate_bits) * (31 + MM_F12_SQR + MM_F12_MUL)
            + (sum(ate_bits) + 2) * (42 + MM_F12_MUL))


def mm_wpow(n_bits, cyc):
    """Montgomery products of one windowed power: 3 squares and 3 products
    for the table, then 3 squares and a product per further window."""
    sq = MM_F12_CSQR if cyc else MM_F12_SQR
    return 3 * (sq + MM_F12_MUL) + ((n_bits + 2) // 3 - 1) * (3 * sq
                                                              + MM_F12_MUL)


def mm_pow(k, n_bits):
    """Montgomery products, summed over the rows, that f^k needs for the
    low n_bits of each row's k (plain 16-bit limbs, LSB first): a square
    for each bit below the highest set one and a product for each set bit
    after the first (which only copies f into the accumulator). The kernel
    squares at every bit and computes the product at every bit, keeping it
    by mask; the bound counts only what this run's exponents need."""
    bits = (k.long()[:, :, None] >> torch.arange(16, device=k.device)) & 1
    bits = bits.reshape(k.shape[0], -1)[:, :n_bits]
    ones = bits.sum(1)
    top = torch.where(bits.bool(), torch.arange(n_bits, device=k.device),
                      -1).amax(1)
    set_rows = ones > 0
    return int((top[set_rows] * MM_F12_SQR
                + (ones[set_rows] - 1) * MM_F12_MUL).sum())


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report, kernel):
    """Registers, stack and spill bytes of `kernel` in a ptxas report."""
    lines = report.splitlines()
    for j, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            text = " ".join(lines[j:j + 4])
            nums = [re.search(pat, text) for pat in (
                r"Used (\d+) registers", r"(\d+) bytes stack frame",
                r"(\d+) bytes spill stores", r"(\d+) bytes spill loads")]
            regs, stack, st, ld = (m.group(1) if m else "?" for m in nums)
            return (f"{regs} registers, {stack}-byte stack, spill stores "
                    f"{st} B, spill loads {ld} B")
    return "not in the ptxas report"


def crafted_fixed_base_cases(C, F, refimpl, device):
    """(name, table, scalars) whose fixed-base sums send the team kernel's
    complete adds, in the lanes' windows and in the tree, through every
    branch (tests/test_torch_kernels_redesign.py checks that they do).
    Table "same" holds P at every digit of every window, table "alt" P in
    even windows and -P in odd ones; digit 0 is the table's infinity. The
    scalars' digits (window w is hex digit w, least significant first):
    all 1 ("same": every add is a double; "alt": a lane's P + (-P) is
    infinity and the tree adds infinities); a checkerboard whose partial
    sums 2P and -2P meet in the tree on "alt"; a zero upper half (the tree
    adds a point and infinity); all 0. C, F, refimpl: the port's curve,
    field and refimpl modules."""
    P = refimpl.g1_mul(refimpl.G1, 5)
    same = C.from_ref_batch([None] + [P] * 15)
    neg = C.from_ref_batch([None] + [refimpl.g1_neg(P)] * 15)
    tables = {"same": same.expand(64, 16, 3, 16),
              "alt": torch.stack([neg if w % 2 else same for w in range(64)])}
    digits = [[1] * 64, [int((w % 4 + w // 4) % 2 == 0) for w in range(64)],
              [3] * 32 + [0] * 32, [0] * 64]
    ks = F.from_int([sum(d << (4 * w) for w, d in enumerate(ds))
                     for ds in digits]).to(device)
    return [(name, t.contiguous().to(device), ks)
            for name, t in tables.items()]


# crafted scalars of the variable-base ladder: 0, 1, 15, 16, n - 1, n (its
# last add is P + (-P)), n + 1, 2^256 - 1, top and bottom digits with 62
# zero windows between, and 16 a + 15 with 16 a = 15 (mod n) (its last add
# is Q + Q, the complete add's double)
def crafted_ladder_scalars(n_order):
    return [0, 1, 15, 16, n_order - 1, n_order, n_order + 1, (1 << 256) - 1,
            (0xF << 252) | 0xF,
            16 * (15 * pow(16, -1, n_order) % n_order) + 15]


def crafted_ladder_cases(C, F, refimpl, device):
    """(points, scalars) for the variable-base ladder: the crafted scalars
    on multiples of the generator, then the point at infinity with 5. At
    W = 64 their ladders meet every branch of the complete add (a double,
    P + (-P), either operand at infinity; tests/test_torch_team_kernels.py
    checks that they do). C, F, refimpl: the port's curve, field and
    refimpl modules."""
    ks = crafted_ladder_scalars(refimpl.N) + [5]
    pts = [refimpl.g1_mul(refimpl.G1, 3 + j) for j in range(len(ks) - 1)]
    return (C.from_ref_batch(pts + [None]).to(device),
            F.from_int(ks).to(device))


def crafted_g2_ladder_cases(G2, F, refimpl, device):
    """(points, scalars) for the G2 ladder: the crafted scalars of
    crafted_ladder_scalars on multiples of the twist's generator, then the
    point at infinity with 5. Their ladders meet every branch of the
    complete add, as on G1 (tests/test_torch_team_kernels.py checks that
    they do). G2, F, refimpl: the port's g2, field and refimpl modules."""
    ks = crafted_ladder_scalars(refimpl.N) + [5]
    pts = [refimpl.g2_mul(refimpl.G2, 3 + j) for j in range(len(ks) - 1)]
    return (torch.stack([G2.from_ref(q) for q in pts + [None]]).to(device),
            F.from_int(ks).to(device))


WPOW_BITS = (1, 2, 3, 4, 63, 64, 128, 256)
# phase 2's crafted rows of the windowed power held against the 128-bit
# cyclotomic run (the rest of the cyclotomic ones have a run of their own
# or share a main shape's; the generic ones share one 256-bit run), and
# the Fp12 power's crafted rows held against its 256-bit run
WPOW_FOLD_CYC = (1, 2, 3, 4, 64)


def wpow_read(n_bits):
    """The bits of k the windowed power reads at n_bits: whole 3-bit
    windows."""
    return 3 * -(-n_bits // 3)


def low_bits(k, bits):
    """(N, 16) plain scalar limbs masked to their low `bits` bits."""
    lo = k.to(torch.int64)
    w = torch.arange(16, device=k.device)
    keep = ((bits - 16 * w).clamp(0, 16))
    return (lo & ((1 << keep) - 1)).to(k.dtype)


def crafted_wpow_cases(F, F12, params, refimpl, device):
    """(f, k) for the windowed GT power: five GPhi12 members gtB^(j + 2)
    and, last, one value outside GPhi12 (where the cyclotomic square is not
    a square); exponents 0, 1, 2^256 - 1, u and two with set bits at the
    limb edges that 3-bit windows straddle (bits 15-17, 47-49, 127-129).
    F, F12, params, refimpl: the port's modules."""
    gtb = refimpl.pair(refimpl.G1, refimpl.G2)
    vals, cur = [], refimpl.fp12_mul(gtb, gtb)
    for _ in range(5):
        vals.append(cur)
        cur = refimpl.fp12_mul(cur, gtb)
    rng = np.random.default_rng(29)
    vals.append(tuple(tuple(int.from_bytes(rng.bytes(40), "little")
                            % refimpl.P for _ in range(2)) for _ in range(6)))
    edges = sum(7 << b for b in (15, 47, 127))
    ks = [0, 1, (1 << 256) - 1, params.U, edges, edges ^ ((1 << 256) - 1)]
    return (F12.from_ref_batch(vals).to(device), F.from_int(ks).to(device))


POW_BITS = (1, 48, 63, 256)
POW_FOLD = (1, 63)


def crafted_pow_cases(F, F12, refimpl, n_bits, device):
    """(f, k), 12 rows, for the Fp12 power at n_bits: a seeded value
    outside GPhi12 with the exponents 0, 1, 2^n_bits - 1, every bit from
    n_bits up set and none below (the power must ignore them; 0 at 256
    bits) and a seeded one; then 1, the unit slots w^j, j = 1 ... 5 (a
    single non-zero slot, which a wrong slot map moves), and a GPhi12
    member (the pairing of the generators), each with a seeded exponent
    whose bits above n_bits are set too. F, F12, refimpl: the port's
    modules."""
    rng = np.random.default_rng(53)
    rand = lambda: [tuple(int.from_bytes(rng.bytes(40), "little")
                          % refimpl.P for _ in range(2)) for _ in range(6)]
    zero, one = refimpl.FP2_ZERO, refimpl.FP2_ONE
    units = [[one if m == j else zero for m in range(6)] for j in range(1, 6)]
    low = (1 << n_bits) - 1
    seeded = lambda: int.from_bytes(rng.bytes(32), "little")
    g = rand()
    rows = [g] * 5 + [refimpl.FP12_ONE, *units,
                      refimpl.pair(refimpl.G1, refimpl.G2)]
    ks = [0, 1, low, ((1 << 256) - 1) ^ low] + [seeded() for _ in range(8)]
    return (F12.from_ref_batch(rows).to(device), F.from_int(ks).to(device))


REDUCE_RS = (1, 2, 3, 10)


def crafted_reduce_cases(C, params, refimpl, r, device):
    """(r, 7, 3, 16) summands of the reduce, one column a case; for r >= 2
    their chains send the complete add through every branch
    (tests/test_torch_reduce_slotmul.py checks that they do):
      0. distinct multiples of the generator;
      1. row 0 at infinity;
      2. row r // 2 at infinity;
      3. the last row the sum of the rows before it (the last add doubles);
      4. row 1 the negation of row 0 (the sum meets infinity, then goes on);
      5. the last row the negation of the sum before it (the sum ends at
         infinity);
      6. every row at infinity.
    Finite summands are Jacobian with Z = 2 + j + c at row j, column c
    (not affine, as the main path's are not). Seven columns are not a
    multiple of the columns a block of the kernel holds. C, params,
    refimpl: the port's curve, params and refimpl modules."""
    P = params.P
    mont = lambda v: params.to_limbs(v * params.R % P)
    cols = [[refimpl.g1_mul(refimpl.G1, 5 + 7 * j + 100 * c)
             for j in range(r)] for c in range(7)]
    cols[1][0] = None
    cols[2][r // 2] = None
    if r >= 2:
        head = lambda col: functools.reduce(refimpl.g1_add, col[:-1], None)
        cols[3][-1] = head(cols[3])
        cols[4][1] = refimpl.g1_neg(cols[4][0])
        cols[5][-1] = refimpl.g1_neg(head(cols[5]))
    cols[6] = [None] * r

    def jac(pt, z):
        if pt is None:
            return C.from_ref(None)
        x, y = pt
        return torch.tensor([mont(x * z * z % P), mont(y * z ** 3 % P),
                             mont(z)], dtype=torch.int32)

    return torch.stack([torch.stack([jac(cols[c][j], 2 + j + c)
                                     for c in range(7)])
                        for j in range(r)]).to(device)


SLOTMUL_NS = (1, 5, 7)


def crafted_slotmul_cases(params, device):
    """(7, 6, 2, 16) Fp12 rows for the slot maps: every slot 0; every limb
    the canonical maximum p - 1 (stored residues, so the value (p - 1) /
    R); every slot -1 (Montgomery p - 1); two rows that mix 0, p - 1, -1
    and seeded values slot by slot and part by part; two seeded rows.
    Their first 1, 5 and 7 rows are the shapes the CPU tests and the card
    hold them at. params: the port's params module."""
    P = params.P
    rng = np.random.default_rng(31)
    rand = lambda: params.to_limbs(
        int.from_bytes(rng.bytes(40), "little") % P * params.R % P)
    zero, top = params.to_limbs(0), params.to_limbs(P - 1)
    minus1 = params.to_limbs((P - 1) * params.R % P)
    rows = [[(zero, zero)] * 6, [(top, top)] * 6, [(minus1, minus1)] * 6,
            [(zero, top), (top, zero), (minus1, zero), (zero, minus1),
             (rand(), zero), (top, rand())],
            [(rand(), top), (zero, rand()), (minus1, rand()),
             (rand(), minus1), (top, minus1), (zero, zero)],
            [(rand(), rand()) for _ in range(6)],
            [(rand(), rand()) for _ in range(6)]]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def crafted_inv_cases(F12, refimpl, device):
    """(6, 6, 2, 16) Fp12 rows for the inverse: 0 (which maps to 0); 1;
    the Miller loop's output for the generators (outside GPhi12, as the
    final exponentiation's input is); a seeded value (not in GPhi12); a
    seeded value with b = 0 (its odd slots zero, so the norm is a^2) and
    one with a = 0 (its even slots zero, so the norm is -v b^2). F12,
    refimpl: the port's fp12 and refimpl modules."""
    rng = np.random.default_rng(37)
    rand = lambda: [tuple(int.from_bytes(rng.bytes(40), "little")
                          % refimpl.P for _ in range(2)) for _ in range(6)]
    zero = refimpl.FP2_ZERO
    a_only = [c if k % 2 == 0 else zero for k, c in enumerate(rand())]
    b_only = [zero if k % 2 == 0 else c for k, c in enumerate(rand())]
    rows = [refimpl.FP12_ZERO, refimpl.FP12_ONE,
            refimpl.ate_miller_loop(refimpl.G1, refimpl.G2), rand(), a_only,
            b_only]
    return F12.from_ref_batch(rows).to(device)


def crafted_f2_inv_cases(F2, params, device):
    """(9, 2, 16) Fp2 rows for the Fp2 inverse: 0 (which maps to 0); 1;
    (a, 0) and (0, b) for seeded a, b (a norm of one square); -1 - i (the
    value (p - 1, p - 1)); the stored limbs (p - 1, p - 1), the largest
    canonical residues; three seeded values. F2, params: the port's fp2 and
    params modules."""
    rng = np.random.default_rng(43)
    rand = lambda: int.from_bytes(rng.bytes(40), "little") % params.P
    top = params.to_limbs(params.P - 1)
    rows = [F2.from_ref(v) for v in ((0, 0), (1, 0), (rand(), 0),
                                     (0, rand()),
                                     (params.P - 1, params.P - 1))]
    rows.append(torch.tensor([top, top], dtype=torch.int32))
    rows += [F2.from_ref((rand(), rand())) for _ in range(3)]
    return torch.stack(rows).to(device)


def crafted_csqr_cases(F12, refimpl, device):
    """(11, 6, 2, 16) Fp12 rows for the cyclotomic square: 0; 1; the six
    unit slots w^k, k = 0 ... 5 (a single non-zero slot, which a wrong slot
    map moves); a GPhi12 member, the pairing of the generators; two seeded
    values outside GPhi12, where the function is not the square. F12,
    refimpl: the port's fp12 and refimpl modules."""
    rng = np.random.default_rng(47)
    rand = lambda: [tuple(int.from_bytes(rng.bytes(40), "little")
                          % refimpl.P for _ in range(2)) for _ in range(6)]
    zero, one = refimpl.FP2_ZERO, refimpl.FP2_ONE
    units = [[one if m == k else zero for m in range(6)] for k in range(6)]
    rows = [refimpl.FP12_ZERO, refimpl.FP12_ONE, *units,
            refimpl.pair(refimpl.G1, refimpl.G2), rand(), rand()]
    return F12.from_ref_batch(rows).to(device)


def fp_inv_edge_inputs(F, params, device):
    """Edge inputs of the Fp inverse: 0, 1, p - 1, R mod p (the Montgomery
    one) and every power of two below p, as (260, 16) limbs. F, params:
    the port's field and params modules."""
    vals = [0, 1, params.P - 1, params.R % params.P] + [
        1 << k for k in range(256) if 1 << k < params.P]
    return F.from_int(vals).to(device)


def prefixes(plain_max):
    """One plain run at the largest N of a kernel's partly filled blocks,
    shared: `at(n)` gives a plain call that returns that run's first n rows
    (the kernels are row-wise, so row i does not depend on N)."""
    box = {}

    def at(n):
        def call():
            if "out" not in box:
                box["out"] = plain_max()
            return box["out"][:n]
        return call
    return at


def shared_plain(plain, parts, *args):
    """One plain run over several calls' rows, concatenated in order, and
    shared: `part(i)` gives a plain call that returns call i's rows of that
    run (row i of a row-wise kernel does not depend on the others).
    `parts()` gives each call's row-indexed arguments; `args` are the
    arguments they share."""
    box = {}

    def part(i):
        def call():
            if "out" not in box:
                calls = parts()
                box["at"] = np.cumsum([0] + [len(c[0]) for c in calls])
                box["out"] = plain(*(torch.cat([t.to(ts[0].dtype)
                                                for t in ts])
                                     for ts in zip(*calls)), *args)
            at = box["at"]
            return box["out"][at[i]:at[i + 1]]
        return call
    return part


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def parse_payload(buf):
    """A DP's range-proof payload (RangeProofList bytes) -> its batches,
    each a dict of numpy byte arrays in the wire layout."""
    def take(n, dtype=np.uint8):
        nonlocal off
        out = np.frombuffer(buf[off:off + n], dtype=dtype)
        off += n
        return out

    off = 0
    _n_values, n_batches = take(16, "<i8")
    batches = []
    for _ in range(int(n_batches)):
        n_idx, _n_blob = take(16, "<i8")
        b = {"idx": take(8 * int(n_idx), "<i8")}
        u, l, v, ns = (int(x) for x in take(32, "<i8"))
        b.update(u=u, l=l)
        for name, shape in (("commit", (v, 128)), ("challenge", (v, 32)),
                            ("zr", (v, 32)), ("d", (v, 64)),
                            ("zphi", (v, l, 32)), ("zv", (ns, v, l, 32)),
                            ("v", (ns, v, l, 128)), ("a", (ns, v, l, 384))):
            b[name] = take(int(np.prod(shape))).reshape(shape)
        batches.append(b)
    if off != len(buf):
        raise SystemExit("payload has trailing bytes")
    return batches


def big(b):
    """A big-endian byte row -> a Python int."""
    return int.from_bytes(b.tobytes(), "big")


def digit_pairing_ok(refimpl, gtb, c, y, zphi, zv, v_bytes, a_bytes):
    """a == e(c y - Zphi B, V) gtB^Zv by the host oracle, every operand
    read from the wire bytes."""
    vals = [big(v_bytes[32 * k:32 * (k + 1)]) for k in range(4)]
    vpt = (None if not any(vals)
           else ((vals[0], vals[1]), (vals[2], vals[3])))
    a = tuple((big(a_bytes[64 * k:64 * k + 32]),
               big(a_bytes[64 * k + 32:64 * (k + 1)])) for k in range(6))
    g1 = refimpl.g1_add(refimpl.g1_mul(y, c),
                        refimpl.g1_neg(refimpl.g1_mul(refimpl.G1, zphi)))
    return refimpl.fp12_mul(refimpl.pair(g1, vpt),
                            refimpl.fp12_pow(gtb, zv)) == a


def tamper_zv(buf):
    """The payload with the last (least significant) byte of its first Zv
    scalar (server 0, value 0, digit 0) changed."""
    n_idx = int(np.frombuffer(buf[16:24], dtype="<i8")[0])
    head = 32 + 8 * n_idx
    _u, l, v, _ns = (int(x) for x in np.frombuffer(buf[head:head + 32], "<i8"))
    at = head + 32 + v * (128 + 32 + 32 + 64) + v * l * 32 + 31
    b = bytearray(buf)
    b[at] ^= 1
    return bytes(b)


class HostTimer:
    """Calls of a host function, with the wall time of each call and the
    CPU time of its thread in it, summed over every thread that calls it.
    Threads that wait for the interpreter lock add wall time, not CPU
    time."""

    def __init__(self, module, name):
        self.fn = getattr(module, name)
        self.lock = threading.Lock()
        self.reset()

        def timed(*a, **k):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.fn(*a, **k)
            finally:
                with self.lock:
                    self.seconds += time.perf_counter() - t0
                    self.cpu += time.thread_time() - c0
                    self.calls += 1
        setattr(module, name, timed)

    def reset(self):
        with self.lock:
            self.seconds, self.cpu, self.calls = 0.0, 0.0, 0


def phase7(stats, X, y, params, zero_launches, launch_counts):
    """The proofs-on survey of bench.py:_proofs_on_cluster through the
    port's LocalCluster on the card. Returns (launches, [the warm wall
    time], the warm run's VerifyRange, the warm run's SurveyResult)."""
    import pickle

    from drynx_tpu_torch.proofs import schnorr
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cluster = cluster_pima(X, y)
    V = stats.shape[1]
    sq = cluster.generate_survey_query("log_reg", proofs=1, lr_params=params,
                                       ranges=[(U, L)] * V, thresholds=1.0)
    print(f"phase 7 setup: cluster keys, tables and {N_SERVERS} signature "
          f"sets of u={U} {time.perf_counter() - t0:.1f} s", flush=True)
    sign = HostTimer(schnorr, "sign")
    check = HostTimer(schnorr, "verify")
    sid = sq.survey_id
    clear = stats.sum(0).cpu()

    def run():
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        sign.reset()
        check.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run_survey(sq, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_block(res.block, N_VNS * (NUM_DPS + 2 * N_SERVERS),
                    "cluster survey")
        dec = torch.from_numpy(res.decrypted.values)
        if not res.decrypted.found.all() or not torch.equal(dec, clear):
            raise SystemExit("decrypted values differ from the clear sums")
        return wall, res

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    first_s, res = run()
    launches7 = launch_counts()
    rows7 = {k: dict(sorted(v.items()))
             for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
    print(f"phase 7: first proofs-on cluster survey {first_s:.3f} s, "
          f"{warm_s(res.timers)}; launches {launches7}", flush=True)
    print(f"phase 7: launch shapes, {{kernel: {{rows: launches}}}}: {rows7}",
          flush=True)
    if launches7 != EXPECTED_LAUNCHES_CLUSTER:
        raise SystemExit(f"cluster survey launches {launches7} differ from "
                         f"{EXPECTED_LAUNCHES_CLUSTER}")
    for name, want in CLUSTER_ROWS.items():
        if rows7.get(name) != want:
            raise SystemExit(f"cluster survey {name} shapes {rows7.get(name)}"
                             f" differ from {want}, phase 2's")
    w_err, w_tol = lr_weights_ok(res, params, "cluster survey")
    digest = transcript_digest(cluster.vns, sid)
    print(f"  audit block #{res.block.index}: {len(res.block.data.bitmap)} "
          f"entries, all BM_TRUE; all {V} values exact and found; weights "
          f"max abs err vs CPU GD {w_err:.3g} (tolerance {w_tol:.3g}); "
          f"transcript {digest[:16]}; Schnorr {sign.calls} signs "
          f"{sign.cpu:.3f} s CPU, {check.calls} checks {check.cpu:.3f} s "
          f"CPU", flush=True)

    # the warm run: the same seed, the same transcript
    wall, res = run()
    again = transcript_digest(cluster.vns, sid)
    if again != digest:
        raise SystemExit("a second run with the same seed gives "
                         f"transcript {again}, not {digest}")

    # a key-switch payload from a VN's store, and a copy with one zx limb
    # changed, through the VN's own verifier
    vn = cluster.vns.vns[1]
    data = vn.stored_proofs(sid)[f"{sid}/keyswitch/cn0/keyswitch-cn0"]
    proof = safe_loads(data)
    proof.zx[1, 7, 0] ^= 1
    vks = vn.verify_fns["keyswitch"]
    ok, bad = vks(data, sid), vks(pickle.dumps(proof), sid)
    if ok is not True or bad is not False:
        raise SystemExit(f"key-switch verifier: honest {ok}, tampered {bad}")

    sign_s, check_s = sign.cpu, check.cpu
    print(f"  the same transcript from a second run; key-switch payload "
          f"accepted, with one zx limb changed rejected", flush=True)
    print(f"phase 7: cluster survey wall time {wall:.4f} s warm (the second "
          f"run); phase timers: " + phase_timers([res])
          + f"; Schnorr CPU time: {sign.calls} signs {sign_s:.4f} s "
          f"+ {check.calls} checks {check_s:.4f} s = {sign_s + check_s:.4f} s"
          f" ({100 * (sign_s + check_s) / wall:.1f} % of the wall time; "
          f"{sign.seconds + check.seconds:.4f} s of call wall time summed "
          f"over threads); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    cluster.close()
    return (launches7, [wall], dict(res.timers.items()).get("VerifyRange"),
            res)


def phase8(zero_launches, launch_counts):
    """The obfuscated max of minmax.toml through the port's LocalCluster
    on the card. Returns (launches, [the warm wall time])."""
    import pickle

    from drynx_tpu_torch.crypto import params
    from drynx_tpu_torch.proofs import requests as rq
    from drynx_tpu_torch.proofs import schnorr
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.service.query import query_to_proofs_nbrs
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=MAX_DPS, n_vns=N_VNS,
                           seed=CLUSTER_SEED, dlog_limit=MAX_DLOG)
    rng = np.random.default_rng(MAX_DATA_SEED)
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, MAX_QMAX + 1, size=MAX_ROWS)
    clear = max(int(dp.data.max()) for dp in cluster.dps.values())
    query = lambda obf: cluster.generate_survey_query(
        "max", query_min=0, query_max=MAX_QMAX, proofs=1, obfuscation=obf,
        ranges=[(2, 1)] * (MAX_QMAX + 1), thresholds=1.0)
    sq, sq_plain = query(True), query(False)
    cluster.ensure_range_sigs(2)
    torch.cuda.synchronize()
    sign = HostTimer(schnorr, "sign")
    check = HostTimer(schnorr, "verify")
    print(f"phase 8 setup: cluster keys, tables and {N_SERVERS} signature "
          f"sets of u=2 {time.perf_counter() - t0:.1f} s", flush=True)

    # every envelope the survey signs, for the batched Schnorr check
    sent, new_request = [], rq.new_proof_request

    def recorded(*a, **k):
        req = new_request(*a, **k)
        sent.append(req)
        return req

    def run(q):
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        sent.clear()
        sign.reset()
        check.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run_survey(q, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_block(res.block, N_VNS * sum(query_to_proofs_nbrs(q)),
                    "obfuscated max")
        if res.result != clear:
            raise SystemExit(f"decoded max {res.result}, clear max {clear}")
        return wall, res

    rq.new_proof_request = recorded
    try:
        zero_launches()
        first_s, res = run(sq)
        launches8 = launch_counts()
        rows8 = {k: dict(sorted(v.items()))
                 for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
        print(f"phase 8: first obfuscated max survey {first_s:.3f} s, "
              f"{warm_s(res.timers)}; launches {launches8}", flush=True)
        print(f"phase 8: launch shapes, {{kernel: {{rows: launches}}}}: "
              f"{rows8}", flush=True)
        if launches8 != EXPECTED_LAUNCHES_MAX:
            raise SystemExit(f"obfuscated max launches {launches8} differ "
                             f"from {EXPECTED_LAUNCHES_MAX}")
        plain_s, res_plain = run(sq_plain)
        if res_plain.result != res.result:
            raise SystemExit(f"without obfuscation the max is "
                             f"{res_plain.result}, with it {res.result}")
        wall, res = run(sq)
        envelopes = list(sent)
        n_signs, n_checks = sign.calls, check.calls
        sign_s, check_s = sign.cpu, check.cpu
    finally:
        rq.new_proof_request = new_request
    n_entries = len(res.block.data.bitmap)
    print(f"  decoded max {res.result} = the clear max = the survey's "
          f"without obfuscation ({plain_s:.3f} s); audit block "
          f"#{res.block.index}: {n_entries} entries, all BM_TRUE",
          flush=True)

    # one obfuscation payload with one z limb changed, through a VN's own
    # receive path: only that envelope turns BM_FALSE
    sid = sq.survey_id
    vn, other = cluster.vns.vns[1], cluster.vns.vns[0]
    key = f"{sid}/obfuscation/cn0/obfuscation-cn0"
    proof = safe_loads(vn.stored_proofs(sid)[key])
    proof.z[7, 0] ^= 1
    cn = cluster.cns[0]
    req = rq.new_proof_request("obfuscation", sid, cn.name,
                               "obfuscation-cn0", 0, pickle.dumps(proof),
                               cn.secret)
    before = dict(vn.bitmap_for(sid))
    code = vn.receive_proof(req)
    after = vn.bitmap_for(sid)
    changed = {k for k in after if after[k] != before.get(k)}
    if (code != rq.BM_FALSE or changed != {key}
            or other.bitmap_for(sid)[key] != rq.BM_TRUE):
        raise SystemExit(f"tampered obfuscation payload: code {code}, "
                         f"changed entries {sorted(changed)}")

    # the batched Schnorr check against the host's on every envelope of the
    # last survey and on three forgeries of each of the first three: another
    # message, s + 1, R off the curve
    pubs = [sq.id_to_public[r.sender_id] for r in envelopes]
    msgs = [r.signed_payload() for r in envelopes]
    sigs = [r.signature for r in envelopes]
    for p, m, sg in list(zip(pubs, msgs, sigs))[:3]:
        s1 = (int.from_bytes(sg.s_bytes, "big") + 1) % params.N
        r1 = bytearray(sg.r_bytes)
        r1[-1] ^= 1
        for m2, sg2 in ((m + b"!", sg),
                        (m, schnorr.Signature(sg.r_bytes,
                                              s1.to_bytes(32, "big"))),
                        (m, schnorr.Signature(bytes(r1), sg.s_bytes))):
            pubs.append(p)
            msgs.append(m2)
            sigs.append(sg2)
    t0 = time.perf_counter()
    batch = schnorr.verify_batch(pubs, msgs, sigs)
    batch_s = time.perf_counter() - t0
    on_host = [schnorr.verify(p, m, sg)
               for p, m, sg in zip(pubs, msgs, sigs)]
    want = [True] * len(envelopes) + [False] * 9
    if batch.tolist() != on_host or on_host != want:
        raise SystemExit(f"verify_batch {batch.tolist()} against host "
                         f"verify {on_host}")
    print(f"  a tampered obfuscation payload recorded BM_FALSE for its "
          f"envelope only; verify_batch agrees with host verify on "
          f"{len(envelopes)} envelopes and 9 forgeries ({batch_s:.3f} s)",
          flush=True)

    print(f"phase 8: obfuscated max survey wall time {wall:.4f} s warm (the "
          f"third run); phase timers: " + phase_timers([res])
          + f"; Schnorr CPU time: {n_signs} signs {sign_s:.4f} s + "
          f"{n_checks} checks {check_s:.4f} s = {sign_s + check_s:.4f} s "
          f"({100 * (sign_s + check_s) / wall:.1f} % of the wall time)",
          flush=True)
    cluster.close()
    return launches8, [wall]


class KeptCalls:
    """The kernels at the sizes a run gives them. Inside `with`, each
    wrapper of `wrappers` keeps, under the current `tag`, its largest call
    with each set of its other non-tensor arguments (the slot map, the
    power's bits, the ladder's windows; the reduce: its first call of each
    shape): a row-wise kernel its first
    and last KEPT_EDGE rows (the last holding its final partly filled
    block) of every argument indexed by row, its other arguments and those
    rows of its output; the reduce the whole call. `hold()` then holds them
    byte for byte against the plain versions on the card: the reduce one
    call a shape, a row-wise kernel the kept rows of every tag in one plain
    call for each set of its other arguments (row i of a row-wise kernel
    does not depend on the others). Keeping launches nothing, and a call
    that the warm-up registry makes (uncounted: `cuda_build.counting()` is
    false) is not kept."""

    # (module, wrapper, the positional arguments indexed by row; None: the
    # reduce, whose output rows sum its input's)
    G1 = [("cuda_ops", "fixed_base_mul_flat", (1,)),
          ("cuda_ops", "scalar_mul_flat", (0, 1)),
          ("cuda_ops", "point_add_flat", (0, 1)),
          ("cuda_ops", "point_reduce_flat", None),
          ("cuda_pairing", "fp_inv_flat", (0,))]
    PAIRING = [("cuda_pairing", "f2_inv_flat", (0,)),
               ("cuda_pairing", "g2_scalar_mul_flat", (0, 1)),
               ("cuda_pairing", "f12_mul_flat", (0, 1)),
               ("cuda_pairing", "f12_mulreduce8_flat", (0,)),
               ("cuda_pairing", "miller_flat", (0, 1, 2, 3)),
               ("cuda_pairing", "f12_inv_flat", (0,)),
               ("cuda_pairing", "f12_csqr_flat", (0,)),
               ("cuda_pairing", "f12_slotmul_flat", (0,)),
               ("cuda_pairing", "f12_wpow_flat", (0, 1))]

    def __init__(self, wrappers=G1):
        import importlib

        self.wrappers = list(wrappers)
        self.mods = {m: importlib.import_module(f"drynx_tpu_torch.crypto.{m}")
                     for m, _, _ in self.wrappers}
        self.cuda_build = importlib.import_module(
            "drynx_tpu_torch.utils.cuda_build")
        self.kept, self.lock, self.tag = {}, threading.Lock(), ""

    def _keeper(self, orig, name, row_args):
        def call(*a, **k):
            out = orig(*a, **k)
            if not self.cuda_build.counting():
                return out       # the warm-up registry's launches
            with self.lock:
                if row_args is None:
                    key = (name, self.tag, tuple(a[0].shape[:2]))
                    if key not in self.kept:
                        self.kept[key] = ([t.clone() for t in a], dict(k),
                                          out.clone(), None)
                    return out
                params = tuple(x for i, x in enumerate(a)
                               if i not in row_args and not torch.is_tensor(x))
                params += tuple(sorted(k.items()))
                key, n = (name, self.tag, params), len(out)
                have = self.kept.get(key)
                if have is None or n > have[3]:
                    idx = torch.cat([
                        torch.arange(min(n, KEPT_EDGE)),
                        torch.arange(max(min(n, KEPT_EDGE), n - KEPT_EDGE),
                                     n)]).to(
                        out.device)
                    self.kept[key] = (
                        [t[idx].clone() if i in row_args else t
                         for i, t in enumerate(a)], dict(k), out[idx].clone(),
                        n)
            return out
        return call

    def __enter__(self):
        self.originals = {}
        for m, name, row_args in self.wrappers:
            orig = self.originals[name] = getattr(self.mods[m], name)
            setattr(self.mods[m], name, self._keeper(orig, name, row_args))
        return self

    def __exit__(self, *exc):
        for m, name, _ in self.wrappers:
            setattr(self.mods[m], name, self.originals[name])

    @staticmethod
    def _same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return (torch.is_tensor(x) and torch.is_tensor(y)
                    and x.shape == y.shape and torch.equal(x, y))
        return x == y

    def hold(self):
        """{kernel: [(tag, rows or (R, N) for the reduce[, the other
        arguments])]} of the calls held; raises SystemExit on a difference
        or a wrapper never called."""
        held, groups = {}, {}
        for key, (a, k, out, n) in sorted(self.kept.items(), key=str):
            name, tag = key[0], key[1]
            m, _, row_args = next(w for w in self.wrappers if w[1] == name)
            plain = getattr(self.mods[m], name.replace("_flat", "_plain"))
            if row_args is None:
                if not torch.equal(out, plain(*a, **k)):
                    raise SystemExit(f"{name} at {key[2]} ({tag}) differs "
                                     f"from its plain version")
                held.setdefault(name[:-5], []).append((tag, key[2]))
                continue
            label = (tag, n) + ((key[2],) if key[2] else ())
            # one plain call for every kept call with the same other
            # arguments
            same = groups.setdefault(name, [])
            for g in same:
                ga, gk = g[0][0], g[0][1]
                if gk == k and all(i in row_args or self._same(x, ga[i])
                                   for i, x in enumerate(a)):
                    g.append((a, k, out, label))
                    break
            else:
                same.append([(a, k, out, label)])
        for name, gs in groups.items():
            m, _, row_args = next(w for w in self.wrappers if w[1] == name)
            plain = getattr(self.mods[m], name.replace("_flat", "_plain"))
            for g in gs:
                a0, k0 = g[0][0], g[0][1]
                args = [torch.cat([e[0][i] for e in g]) if i in row_args
                        else x for i, x in enumerate(a0)]
                got = torch.cat([e[2] for e in g])
                want = plain(*args, **k0)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise SystemExit(f"{name} at {[e[3] for e in g]} differs "
                                     f"from its plain version")
                held.setdefault(name[:-5], []).extend(e[3] for e in g)
        names = {n[:-5] for _, n, _ in self.wrappers}
        if set(held) != names:
            raise SystemExit(f"no call of {sorted(names - set(held))} kept")
        return held


def phase9(zero_launches, launch_counts):
    """The noised sum through the port's LocalCluster on the card, then
    the DRO pipeline alone at 100,000 values. Returns (launches, [the warm
    wall time])."""
    import glob
    import os
    import pickle
    import tempfile

    from drynx_tpu_torch import pool as pool_mod
    from drynx_tpu_torch.crypto import cuda_ops
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.crypto import params
    from drynx_tpu_torch.parallel import dro
    from drynx_tpu_torch.pool import replenish
    from drynx_tpu_torch.proofs import requests as rq
    from drynx_tpu_torch.proofs import schnorr
    from drynx_tpu_torch.proofs import shuffle as shp
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.service.query import DiffPParams
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    diffp = DiffPParams(noise_list_size=NOISE_SIZE, **NOISE_DIFFP)
    laplace = [NOISE_DIFFP[k] for k in ("lap_mean", "lap_scale", "quanta",
                                        "scale", "limit")]
    clear_noise = np.sort(dro.generate_noise_values(NOISE_SIZE, *laplace))
    n_slabs = -(-NOISE_SIZE // dro.CHUNK) if NOISE_SIZE > dro.CHUNK else 1
    digit_proofs = NOISE_DPS * NOISE_RANGES[1] * N_SERVERS
    want = {fresh: noised_sum_launches(N_SERVERS, n_slabs, digit_proofs,
                                       fresh) for fresh in (True, False)}

    def make_cluster(pool=None):
        c = LocalCluster(n_cns=N_SERVERS, n_dps=NOISE_DPS, n_vns=N_VNS,
                         seed=CLUSTER_SEED, dlog_limit=NOISE_DLOG, pool=pool)
        rng = np.random.default_rng(NOISE_DATA_SEED)
        for dp in c.dps.values():
            dp.data = rng.integers(0, NOISE_QMAX, size=NOISE_ROWS)
        q = c.generate_survey_query("sum", query_min=0, query_max=NOISE_QMAX,
                                    proofs=1, ranges=[NOISE_RANGES],
                                    diffp=diffp, thresholds=1.0)
        c.ensure_range_sigs(NOISE_RANGES[0])
        torch.cuda.synchronize()
        return c, q

    t0 = time.perf_counter()
    cluster, sq = make_cluster()
    clear = sum(int(dp.data.sum()) for dp in cluster.dps.values())
    coll_x = sum(c.secret for c in cluster.cns) % params.N
    print(f"phase 9 setup: cluster keys, tables and {N_SERVERS} signature "
          f"sets of u={NOISE_RANGES[0]} {time.perf_counter() - t0:.1f} s",
          flush=True)
    sign = HostTimer(schnorr, "sign")
    check = HostTimer(schnorr, "verify")
    host = {name: HostTimer(shp, name) for name in (
        "_ilmpp_responses", "_digest_scalars", "_relation_secret")}
    timers = [sign, check, *host.values()]

    # the last shuffle's output: the final noise list
    last, shuffle = {}, dro.shuffle_rerandomize

    def recorded(*a, **k):
        out = shuffle(*a, **k)
        last["out"] = out[0]
        return out

    def run(c, q):
        for vn in c.vns.vns:
            vn.verify_cache.clear()
        for t in timers:
            t.reset()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = c.run_survey(q, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        rows = {k: dict(sorted(v.items()))
                for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
        check_block(res.block, NOISE_BITMAP_ENTRIES, "noised sum")
        n_shuffle = sum("/shuffle/" in k for k in res.block.data.bitmap)
        if n_shuffle != N_VNS * N_SERVERS:
            raise SystemExit(f"audit block: {n_shuffle} shuffle entries")
        vals, found = eg.decrypt_ints(last["out"], coll_x, c.dlog)
        vals = vals.cpu().numpy().astype(np.int64)
        if not bool(found.all()) or not np.array_equal(np.sort(vals),
                                                       clear_noise):
            raise SystemExit("the final noise list does not decrypt to a "
                             "permutation of the clear noise list")
        if int(res.result) != clear + int(vals[0]) or abs(int(vals[0])) > 8:
            raise SystemExit(f"noised sum {res.result}, clear {clear}, "
                             f"noise at index 0 {vals[0]}")
        stamp = {"sign": sign.cpu, "check": check.cpu,
                 **{k: t.cpu for k, t in host.items()}}
        return wall, res, launches, rows, int(vals[0]), stamp

    def report(tag, first, warm):
        wall, res, cpu = warm[0], warm[1], warm[5]
        print(f"phase 9{tag}: " + ("" if first is None else
                                   f"first run {first:.3f} s; ")
              + f"a warm run {wall:.4f} s; phase timers: "
              + phase_timers([res])
              + f"; CPU time: Schnorr {sign.calls} signs "
              f"{cpu['sign']:.4f} s + {check.calls} checks "
              f"{cpu['check']:.4f} s ({100 * (cpu['sign'] + cpu['check']) / wall:.1f}"
              f" % of the wall time); shuffle proofs' host work: ILMPP "
              f"responses {cpu['_ilmpp_responses']:.4f} s, sha3 digests "
              f"{cpu['_digest_scalars']:.4f} s, the sum for s "
              f"{cpu['_relation_secret']:.4f} s", flush=True)
        return [wall]

    dro.shuffle_rerandomize = recorded
    try:
        # (a) fresh precomputation
        first, res, launches9, rows9, n0, _ = run(cluster, sq)
        print(f"phase 9a: first noised sum {first:.3f} s, "
              f"{warm_s(res.timers)}; launches {launches9}", flush=True)
        print(f"phase 9a: launch shapes, {{kernel: {{rows: launches}}}}: "
              f"{rows9}", flush=True)
        if launches9 != want[True]:
            raise SystemExit(f"noised sum launches {launches9} differ from "
                             f"{want[True]}")
        k2 = 2 * NOISE_SIZE + 1
        r_msm = int(np.ceil(np.sqrt(k2)))
        c_msm = -(-k2 // r_msm)
        msm_rows = {(r_msm, 2 * c_msm): 2 * N_SERVERS, (c_msm, 2): 2 * N_SERVERS}
        got_msm = {k: v for k, v in rows9["point_reduce"].items()
                   if k in msm_rows}
        if got_msm != msm_rows:
            raise SystemExit(f"shuffle proofs' reduces {got_msm}, want "
                             f"{msm_rows}")
        sid = sq.survey_id
        digest = transcript_digest(cluster.vns, sid)
        kept = KeptCalls()
        with kept:
            again = run(cluster, sq)
        if transcript_digest(cluster.vns, sid) != digest:
            raise SystemExit("a second noised sum with the same seed gives "
                             "another transcript")
        print(f"  the G1 kernels at the noised sum's sizes, byte-equal to "
              f"their plain versions: {kept.hold()}", flush=True)
        print(f"  audit block #{res.block.index}: {NOISE_BITMAP_ENTRIES} "
              f"entries, all BM_TRUE, {N_VNS * N_SERVERS} shuffle; the final "
              f"list a permutation of the {NOISE_SIZE} clear values; answer "
              f"{res.result} = clear {clear} + noise {n0}; the same "
              f"transcript {digest[:16]} from a second run "
              f"({again[0]:.3f} s)", flush=True)
        # the same-seed second run is the warm run timed (its kept copies
        # are a few thousand rows)
        walls9 = report("a", first, again)

        # a shuffle proof with one z changed, through a VN's receive path
        vn, other = cluster.vns.vns[1], cluster.vns.vns[0]
        key = f"{sid}/shuffle/cn0/shuffle-cn0"
        proof, a, b = safe_loads(vn.stored_proofs(sid)[key])
        proof.z[7] ^= 1
        cn = cluster.cns[0]
        req = rq.new_proof_request("shuffle", sid, cn.name, "shuffle-cn0", 0,
                                   pickle.dumps((proof, a, b)), cn.secret)
        before = dict(vn.bitmap_for(sid))
        code = vn.receive_proof(req)
        after = vn.bitmap_for(sid)
        changed = {k for k in after if after[k] != before.get(k)}
        if (code != rq.BM_FALSE or changed != {key}
                or other.bitmap_for(sid)[key] != rq.BM_TRUE):
            raise SystemExit(f"tampered shuffle payload: code {code}, "
                             f"changed entries {sorted(changed)}")
        print("  a shuffle proof with one z changed recorded BM_FALSE for "
              "its envelope only", flush=True)

        # the shuffle proofs' sums: two reduces against one over every row
        # and a tree of batched adds, on the relation's shape
        final = last["out"]
        rel = torch.cat([final, final, final[:1]])
        chosen = shp._sum_rows(rel)
        one = cuda_ops.point_reduce_flat(rel)

        def tree(p):
            n_add = 0
            while p.shape[0] > 1:
                h = p.shape[0] // 2
                s = C.add(p[:h], p[h:2 * h])
                p = torch.cat([s, p[2 * h:]]) if p.shape[0] % 2 else s
                n_add += 1
            return p[0], n_add

        by_tree, n_tree = tree(rel)
        if not (bool(C.eq(chosen, one).all())
                and bool(C.eq(chosen, by_tree).all())):
            raise SystemExit("the shuffle proofs' sums disagree")
        ms = {name: cuda_ms(fn, 3) for name, fn in (
            ("two reduces", lambda: shp._sum_rows(rel)),
            ("one reduce", lambda: cuda_ops.point_reduce_flat(rel)),
            ("add tree", lambda: tree(rel)))}
        print(f"  the shuffle proofs' sum of {k2} rows x 2 points: two "
              f"reduces ({r_msm}, {2 * c_msm}) then ({c_msm}, 2) "
              f"{ms['two reduces']:.3f} ms (chosen); one reduce ({k2}, 2) "
              f"{ms['one reduce']:.3f} ms; a tree of {n_tree} batched adds "
              f"{ms['add tree']:.3f} ms", flush=True)

        # one shuffle of the final list, its proof and the proof's check
        # alone, with no proof thread running
        gen = torch.Generator(device=dev).manual_seed(NOISE_POOL_SEED)
        out, perm, r = shuffle(final, cluster.coll_tbl.table, gen)
        betas = shp.limbs_to_ints(r)
        for t in host.values():
            t.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = shp.prove_shuffle(final, out, perm, betas, cluster.coll_pt,
                                  np.random.default_rng(NOISE_POOL_SEED))
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        alone = {k: t.seconds for k, t in host.items()}
        t0 = time.perf_counter()
        ok = shp.verify_shuffle(proof, final, out, cluster.coll_pt)
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        if not ok:
            raise SystemExit("a shuffle proof made alone was rejected")
        print(f"  one shuffle proof of {NOISE_SIZE} values alone: prove "
              f"{prove_s:.3f} s (host: ILMPP responses "
              f"{alone['_ilmpp_responses']:.3f} s, sha3 digests "
              f"{alone['_digest_scalars']:.3f} s, the sum for s "
              f"{alone['_relation_secret']:.3f} s), check {check_s:.3f} s",
              flush=True)

        # (b) after prewarm_dro: the phase only permutes and adds
        with tempfile.TemporaryDirectory(prefix="drynx_precomp_") as d:
            t0 = time.perf_counter()
            cluster.prewarm_dro(NOISE_SIZE, n_surveys=1, cache_dir=d)
            torch.cuda.synchronize()
            prewarm_s = time.perf_counter() - t0
            calls = dro.PRECOMPUTE_CALLS
            warm_b = run(cluster, sq)
            if warm_b[2] != want[False]:
                raise SystemExit(f"prewarmed noised sum launches "
                                 f"{warm_b[2]} differ from {want[False]}")
            left = glob.glob(os.path.join(d, "precomp_*.npz"))
            if dro.PRECOMPUTE_CALLS != calls or left:
                extra = dro.PRECOMPUTE_CALLS - calls
                raise SystemExit(f"after prewarm_dro: {extra} fresh "
                                 f"precomputations, {len(left)} files left")
        print(f"phase 9b: prewarm_dro({NOISE_SIZE}, 1 survey) "
              f"{prewarm_s:.3f} s; no fresh precomputation, every "
              f"precompute file deleted", flush=True)
        report("b", None, warm_b)
        cluster.close()

        # (c) once through a CryptoPool filled by replenish.refill_to
        with tempfile.TemporaryDirectory(prefix="drynx_pool_") as d:
            pool = pool_mod.CryptoPool(d, slab_elems=NOISE_SIZE)
            cp, sqp = make_cluster(pool)
            try:
                gen = torch.Generator(device=dev).manual_seed(NOISE_POOL_SEED)
                t0 = time.perf_counter()
                n_fill = replenish.refill_to(pool, gen, cp.coll_tbl.table,
                                             N_SERVERS * NOISE_SIZE)
                torch.cuda.synchronize()
                fill_s = time.perf_counter() - t0
                calls, st0 = dro.PRECOMPUTE_CALLS, pool.stats()
                wall_c, res_c, launches_c, *_ = run(cp, sqp)
                st = pool.stats()
                if (launches_c != want[False] or dro.PRECOMPUTE_CALLS != calls
                        or st["consumed"] - st0["consumed"] != N_SERVERS
                        or st["slabs_live"] != 0):
                    raise SystemExit(f"pooled noised sum: launches "
                                     f"{launches_c}, pool {st}")
            finally:
                cp.close()
        print(f"phase 9c: refill_to filled {n_fill} slabs of {NOISE_SIZE} "
              f"in {fill_s:.3f} s; the pooled noised sum {wall_c:.3f} s "
              f"({warm_s(res_c.timers)}) "
              f"consumed {N_SERVERS} (stats {st})", flush=True)
    finally:
        dro.shuffle_rerandomize = shuffle

    # the noise pipeline alone at 100,000 values, fresh and pooled
    x, pub = eg.keygen(np.random.default_rng(NOISE_SCALE_SEED))
    tbl = eg.pub_table(pub)
    tbl.table = tbl.table.to(dev)
    dl = eg.DecryptionTable(limit=int(NOISE_DIFFP["limit"])).to(dev)
    clear_big = np.sort(dro.generate_noise_values(NOISE_SCALE_SIZE,
                                                  *laplace))
    gen = torch.Generator(device=dev).manual_seed(NOISE_SCALE_SEED)

    def pipeline(pool=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cts, _ = dro.dro_pipeline(tbl, NOISE_SCALE_SIZE, *laplace,
                                  n_servers=N_SERVERS, pool=pool,
                                  generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vals, found = eg.decrypt_ints(cts, x, dl)
        if not bool(found.all()) or not np.array_equal(
                np.sort(vals.cpu().numpy().astype(np.int64)), clear_big):
            raise SystemExit("the pipeline's list does not decrypt to a "
                             "permutation of the clear noise list")
        return wall

    fresh_s = [pipeline() for _ in range(2)]
    with tempfile.TemporaryDirectory(prefix="drynx_pool_") as d:
        pool = pool_mod.CryptoPool(d, slab_elems=NOISE_SCALE_SIZE)
        t0 = time.perf_counter()
        replenish.refill_to(pool, gen, tbl.table, N_SERVERS * NOISE_SCALE_SIZE)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        pooled_s = pipeline(pool)
        if pool.stats()["consumed"] != N_SERVERS:
            raise SystemExit(f"pooled pipeline: pool {pool.stats()}")
    print(f"phase 9: dro_pipeline at {NOISE_SCALE_SIZE} values, "
          f"{N_SERVERS} servers: fresh {fresh_s[0]:.3f} s first, "
          f"{fresh_s[1]:.3f} s warm; pooled {pooled_s:.3f} s (the pool "
          f"filled in {fill_s:.3f} s); each output a permutation of the "
          f"clear list", flush=True)
    return launches9, walls9


def warm_s(timers):
    """The kernel warm-up's seconds in a run's timers (LocalCluster's
    first proofs-on survey runs `compilecache.precompile`)."""
    t = dict(timers.items()).get("PrecompileTraceExec")
    return ("no warm-up (the cluster was warm)" if t is None
            else f"warm-up (PrecompileTraceExec) {t:.3f} s of it")


def check_block(block, want_entries, what):
    """An audit block of `want_entries` entries, every one BM_TRUE."""
    from drynx_tpu_torch.proofs import requests as rq

    bitmap = block.data.bitmap if block is not None else {}
    if len(bitmap) != want_entries or set(bitmap.values()) != {rq.BM_TRUE}:
        raise SystemExit(f"{what}: audit block of {len(bitmap)} entries "
                         f"(want {want_entries}), codes "
                         f"{sorted(set(bitmap.values()))}")


def phase_timers(results):
    """The phase timers of survey results (each timer's median over them),
    as one line."""
    split = {k: statistics.median(dict(r.timers.items()).get(k, 0.0)
                                  for r in results)
             for k in sorted({k for r in results for k, _ in r.timers.items()})}
    return ", ".join(f"{k} {v:.4f} s" for k, v in split.items())


def lr_weights_ok(res, params, what):
    """The survey's weights against GD on the CPU from its decrypted
    values, within 1e-3 (relative to the largest weight, at least 1).
    Returns (the max abs error, the tolerance)."""
    from drynx_tpu_torch.models import logreg as lr

    w = torch.from_numpy(res.result)
    w_cpu = lr.train(lr.unpack(torch.from_numpy(res.decrypted.values),
                               params), params)
    err = float((w - w_cpu).abs().max())
    tol = 1e-3 * max(1.0, float(w_cpu.abs().max()))
    if w.shape != (D + 1,) or not bool(torch.isfinite(w).all()) or err > tol:
        raise SystemExit(f"{what}: weights differ from CPU GD: {err}")
    return err, tol


def phase10a(zero_launches, launch_counts, kept):
    """The grouped survey through the port's LocalCluster on the card.
    Returns (launches, wall times)."""
    from drynx_tpu_torch.encoding import stats as st
    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=NOISE_DPS, n_vns=N_VNS,
                           seed=CLUSTER_SEED, dlog_limit=NOISE_DLOG)
    rng = np.random.default_rng(NOISE_DATA_SEED)
    data, groups = [], []
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, NOISE_QMAX, size=GROUP_ROWS)
        dp.groups = np.stack([rng.choice(np.asarray(v), size=GROUP_ROWS)
                              for v in GROUP_BY], axis=-1)
        data.append(dp.data)
        groups.append(dp.groups)
    data, groups = np.concatenate(data), np.concatenate(groups)
    n_groups = len(GROUP_BY[0]) * len(GROUP_BY[1])
    Vg = NOISE_QMAX + 1
    sq = cluster.generate_survey_query(
        "frequency_count", query_min=0, query_max=NOISE_QMAX, proofs=1,
        ranges=[NOISE_RANGES] * Vg, group_by=GROUP_BY, thresholds=1.0)
    cluster.ensure_range_sigs(NOISE_RANGES[0])
    torch.cuda.synchronize()
    digit_proofs = NOISE_DPS * n_groups * Vg * NOISE_RANGES[1] * N_SERVERS
    print(f"phase 10a setup: cluster, {n_groups} groups x {Vg} values a DP, "
          f"{digit_proofs} digit proofs, {time.perf_counter() - t0:.1f} s",
          flush=True)
    clear = {}
    for g in st.group_grid(GROUP_BY):
        sub = data[np.all(groups == g[None], axis=-1)]
        clear[tuple(int(t) for t in g)] = {v: int((sub == v).sum())
                                           for v in range(Vg)}

    def run():
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run_survey(sq, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check_block(res.block, N_VNS * (NOISE_DPS + 2 * N_SERVERS),
                    "grouped survey")
        if res.result != clear:
            raise SystemExit("a group's histogram differs from its clear "
                             "counts")
        return wall, res, launches

    kept.tag = "10a"
    with kept:
        first, res, launches = run()
    rows = {k: dict(sorted(v.items()))
            for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
    want = survey_launches(digit_proofs, signed_offset=False)
    print(f"phase 10a: first grouped survey {first:.3f} s, "
          f"{warm_s(res.timers)}; launches {launches}", flush=True)
    print(f"phase 10a: launch shapes, {{kernel: {{rows: launches}}}}: {rows}",
          flush=True)
    if launches != want:
        raise SystemExit(f"grouped survey launches {launches} differ from "
                         f"{want}")
    digest = transcript_digest(cluster.vns, sq.survey_id)
    warm, res2, _ = run()
    if transcript_digest(cluster.vns, sq.survey_id) != digest:
        raise SystemExit("a second grouped survey with the same seed gives "
                         "another transcript")
    print(f"  every group's histogram equals its clear counts; audit block "
          f"of {len(res.block.data.bitmap)} entries, all BM_TRUE; the same "
          f"transcript {digest[:16]} from a second run", flush=True)
    print(f"phase 10a: grouped survey wall time {first:.4f} s cold, "
          f"{warm:.4f} s warm; phase timers (warm): "
          + phase_timers([res2]), flush=True)
    cluster.close()
    return launches, [first, warm]


def cluster_pima(X, y):
    """Phase 7's cluster with its DPs' Pima shards."""
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.service.service import LocalCluster

    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=NUM_DPS, n_vns=N_VNS,
                           seed=CLUSTER_SEED, dlog_limit=DLOG_LIMIT)
    for i, dp in enumerate(cluster.dps.values()):
        dp.data = lr.shard_for_dp(X, y, i, NUM_DPS)
    cluster.ensure_range_sigs(U)
    torch.cuda.synchronize()
    return cluster


def phase10b(cluster, stats, params, zero_launches, launch_counts, kept):
    """Phase 7's survey at cutting factor 4 on `cluster` (phase 7's
    configuration). Returns (launches, walls)."""
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    V = stats.shape[1]
    sq = cluster.generate_survey_query(
        "log_reg", proofs=1, lr_params=params, ranges=[(U, L)] * (CUT * V),
        thresholds=1.0, cutting_factor=CUT)
    digit_proofs = NUM_DPS * CUT * V * L * N_SERVERS
    print(f"phase 10b setup: V = {CUT * V} a DP, {digit_proofs} digit "
          f"proofs, {time.perf_counter() - t0:.1f} s", flush=True)
    clear = stats.sum(0).cpu().numpy()
    full = []
    decrypt = cluster._decrypt
    cluster._decrypt = lambda sw: full.append(decrypt(sw)) or full[-1]

    def run():
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        full.clear()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cluster.run_survey(sq, seed=SURVEY_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check_block(res.block, N_VNS * (NUM_DPS + 2 * N_SERVERS),
                    "cut survey")
        reps = full[0].values.reshape(CUT, V)
        if not (full[0].found.all() and (reps == reps[0]).all()):
            raise SystemExit("the cut survey's replicas differ")
        if not np.array_equal(res.decrypted.values, clear):
            raise SystemExit("the first replica differs from phase 7's "
                             "decrypted statistics (the clear sums)")
        return (wall, res, launches,
                lr_weights_ok(res, params, "cut survey")[0])

    kept.tag = "10b"
    with kept:
        first, res, launches, err = run()
    rows = {k: dict(sorted(v.items()))
            for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
    want = survey_launches(digit_proofs, signed_offset=True)
    print(f"phase 10b: first cut survey {first:.3f} s, {warm_s(res.timers)}; "
          f"launches {launches}", flush=True)
    print(f"phase 10b: launch shapes, {{kernel: {{rows: launches}}}}: {rows}",
          flush=True)
    if launches != want:
        raise SystemExit(f"cut survey launches {launches} differ from {want}")
    print(f"  {CUT} replicas of {V} values decrypt equal; the first equals "
          f"the clear sums exactly; weights max abs err vs CPU GD {err:.3g}; "
          f"audit block of {len(res.block.data.bitmap)} entries, all BM_TRUE",
          flush=True)
    print(f"phase 10b: cut survey wall time {first:.4f} s (the cluster's "
          f"first survey); phase timers: " + phase_timers([res]), flush=True)
    del cluster._decrypt
    return launches, [first]


def phase11(cluster, stats, params, zero_launches, launch_counts, kept,
            verify_range_alone):
    """Four of phase 7's surveys through `SurveyServer` (max_batch 4,
    pipelined): the first submit takes the compile lane, the others the
    fast lane; the four run as one group, their range payloads held and
    flushed in one cross-survey check on the verify worker, then
    finalized there; the payloads then replayed to one VN with one
    tampered and flushed again. Returns (launches of the batch, [its wall
    time, the replay's])."""
    from drynx_tpu_torch import compilecache as cc
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.proofs import requests as rq
    from drynx_tpu_torch.server import SurveyServer
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    V = stats.shape[1]
    sqs = [cluster.generate_survey_query(
        "log_reg", proofs=1, lr_params=params, ranges=[(U, L)] * V,
        thresholds=1.0) for _ in range(HELD)]
    sids = [sq.survey_id for sq in sqs]
    digit_proofs = HELD * NUM_DPS * V * L * N_SERVERS
    print(f"phase 11 setup: {HELD} surveys, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    clear = stats.sum(0).cpu().numpy()
    checks, batch_verify = [], rp.verify_range_proofs_batch

    def counted(pb, *a, **k):
        checks.append(pb.n_values * pb.l * pb.n_servers)
        return batch_verify(pb, *a, **k)

    tampered = (sids[2], cluster.dp_idents[TAMPER_DP].name)
    finalized = []

    def finalize(p, _fn=cluster.finalize_survey):
        finalized.append((p.sq.survey_id, threading.current_thread().name))
        return _fn(p)

    def batch():
        for vn in cluster.vns.vns:
            vn.verify_cache.clear()
        server = SurveyServer(cluster, max_batch=HELD, pipeline=True)
        zero_launches()
        checks.clear()
        rp.verify_range_proofs_batch = counted
        cluster.finalize_survey = finalize
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the first submit finds the shape cold; one scheduling step
            # runs the compile lane (the warm-up on this thread), and the
            # rest of the batch then finds it warm
            lanes = [server.submit(sqs[0], seed=0).lane]
            server._drain_step()
            lanes += [server.submit(sq, seed=i).lane
                      for i, sq in enumerate(sqs) if i]
            out = server.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rp.verify_range_proofs_batch = batch_verify
            del cluster.finalize_survey
        if lanes != ["compile"] + ["fast"] * (HELD - 1):
            raise SystemExit(f"admission lanes {lanes}")
        bad = {k: v for k, v in out.items() if isinstance(v, Exception)}
        if bad or sorted(out) != sorted(sids):
            raise SystemExit(f"the server's results: {sorted(out)}, errors "
                             f"{bad}")
        flushes = [n for n, _, _ in server.timers.spans("Pipeline.flush.")]
        if flushes != ["Pipeline.flush." + "+".join(sids)]:
            raise SystemExit(f"the batch's flushes {flushes}, not one over "
                             f"all {HELD} surveys")
        if sorted(finalized) != sorted((sid, "server-verify")
                                       for sid in sids):
            raise SystemExit(f"finalized on {finalized}")
        results = [out[sid] for sid in sids]
        for res in results:
            if not np.array_equal(res.decrypted.values, clear):
                raise SystemExit("a held survey's decrypted statistics "
                                 "differ from phase 7's (the clear sums)")
            lr_weights_ok(res, params, "held survey")
        (_, c0, c1), = server.timers.spans("Compile.")
        (_, f0, f1), = server.timers.spans("Pipeline.flush.")
        return (wall, f1 - f0, results, launch_counts(), list(checks),
                server, c1 - c0)

    kept.tag = "11"
    with kept:
        wall, flush_s, results, launches, checks1, server, compile_s = batch()
    rows = {k: dict(sorted(v.items()))
            for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
    want = {k: HELD * (v - EXPECTED_LAUNCHES_VERIFY[k])
            for k, v in EXPECTED_LAUNCHES_CLUSTER.items()}
    add_launches(want, verify_launches(digit_proofs))
    print(f"phase 11: the server's compile lane {compile_s:.3f} s on the "
          f"drain thread; its warm-up entries:\n"
          + server.compile_stats.table(), flush=True)
    print(f"phase 11: first held batch through SurveyServer {wall:.3f} s "
          f"({wall - compile_s:.3f} s without the compile lane); lanes "
          f"compile, then fast x{HELD - 1}; one group, one flush; finalized "
          f"on server-verify; launches {launches}", flush=True)
    print(f"phase 11: launch shapes, {{kernel: {{rows: launches}}}}: {rows}",
          flush=True)
    if launches != want:
        raise SystemExit(f"held batch launches {launches} differ from {want}")
    names = {e.name for e in cc.build_registry(
        server.admission.profile_for(sqs[0]), cluster)}
    missing = sorted(f"kernel:{k}" for k in cuda_build.LAUNCH_ROWS
                     if f"kernel:{k}" not in names)
    if missing:
        raise SystemExit(f"launches outside the registry: {missing}")
    print(f"  every kernel the batch launched names an entry of the "
          f"registry for its profile", flush=True)
    for res in results:
        check_block(res.block, N_VNS * (NUM_DPS + 2 * N_SERVERS),
                    "held survey")
    if checks1 != [digit_proofs]:
        raise SystemExit(f"the cross flush ran RLC checks of {checks1} digit "
                         f"proofs, not one of {digit_proofs}")
    own = sum(dict(r.timers.items()).get("VerifyRange", 0.0)
              for r in results)
    print(f"  {HELD} all-BM_TRUE blocks; every survey's decrypted statistics "
          f"equal the clear sums, weights within tolerance of CPU GD; the "
          f"payloads checked in one RLC batch of {checks1[0]} digit proofs; "
          f"flush {flush_s:.4f} s (VerifyRange summed over the {HELD} "
          f"surveys {own:.4f} s; one survey's own joint check in phase 7: "
          f"{verify_range_alone}, x{HELD})", flush=True)

    # the four surveys' range payloads from a VN's store, re-signed and
    # delivered again to that VN with one Zv byte of DP TAMPER_DP's payload
    # of the third survey changed, held and flushed as one cross batch:
    # BM_FALSE for that envelope only
    vn = cluster.vns.vns[1]
    idents = {d.name: d for d in cluster.dp_idents}
    stored = {sid: {k: v for k, v in vn.stored_proofs(sid).items()
                    if "/range/" in k} for sid in sids}
    key = f"{tampered[0]}/range/{tampered[1]}/range-{tampered[1]}"
    t1 = time.perf_counter()
    for sid in sids:
        vn.register_survey(sid, NUM_DPS, {"range": 1.0},
                           expected_range=NUM_DPS, hold_range=True)
        for k, data in sorted(stored[sid].items()):
            dp = idents[k.split("/")[2]]
            if k == key:
                data = tamper_zv(data)
            vn.receive_proof(rq.new_proof_request(
                "range", sid, dp.name, f"range-{dp.name}", 0, data,
                dp.secret))
    checks.clear()
    rp.verify_range_proofs_batch = counted
    try:
        t2 = time.perf_counter()
        flushed = vn.flush_ranges_cross(sids)
        torch.cuda.synchronize()
        flush2 = time.perf_counter() - t2
    finally:
        rp.verify_range_proofs_batch = batch_verify
    replay_s = time.perf_counter() - t1
    bad = {sid: {k for k, v in vn.bitmap_for(sid).items() if v != rq.BM_TRUE}
           for sid in sids}
    if (sorted(flushed) != sorted(sids) or vn.bitmap_for(tampered[0])[key]
            != rq.BM_FALSE or any(bad[sid] != ({key} if sid == tampered[0]
                                                else set()) for sid in sids)
            or any(len(vn.bitmap_for(sid)) != NUM_DPS for sid in sids)):
        raise SystemExit(f"tampered cross flush: entries not BM_TRUE {bad}")
    print(f"  the {HELD} surveys' {HELD * NUM_DPS} range payloads replayed "
          f"to {vn.name} with one Zv byte of {tampered[1]}'s payload of "
          f"survey 3 changed: BM_FALSE for that envelope only, every other "
          f"BM_TRUE; RLC checks of {checks} digit proofs; flush "
          f"{flush2:.4f} s ({replay_s:.3f} s with the envelopes)",
          flush=True)
    wall2 = replay_s
    print(f"phase 11: held batch wall time {wall:.4f} s (flush "
          f"{flush_s:.4f} s); phase timers, median of the {HELD} surveys: "
          + phase_timers(results),
          flush=True)
    return launches, [wall, wall2]


def phase12(zero_launches, launch_counts, kept):
    """The stream of scripts/bench_stream.py's headline through the port's
    StreamEngine on the card. Returns (launches of the steady advance,
    its wall time)."""
    import tempfile
    from collections import Counter

    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.service import topology as topo
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.service.store import ProofDB
    from drynx_tpu_torch.service.streaming import StreamEngine

    S = STREAM
    V, W, PW = S["V"], S["w"], S["pw"]
    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=S["n_cns"], n_dps=S["n_dps"],
                           n_vns=S["n_vns"], seed=S["seed"],
                           dlog_limit=S["dlog"])
    rng = np.random.default_rng(S["data_seed"])
    rows = {d.name: rng.integers(0, V, size=(W + 3, PW))
            for d in cluster.dp_idents}
    payload_proofs = V * S["ranges"][1] * S["n_cns"]
    tmp = tempfile.TemporaryDirectory(prefix="drynx_panes_")
    db_path = f"{tmp.name}/panes.db"

    def mk(sid, db=None):
        return StreamEngine(cluster, "frequency_count", 0, V - 1,
                            stream_id=sid, pane_width=PW, window_panes=W,
                            ranges=[S["ranges"]] * V, proofs=1,
                            seed=S["engine_seed"], pane_db=db)

    def truth(a, b):
        c = Counter()
        for r in rows.values():
            c.update(r[a:b].reshape(-1).tolist())
        return {v: c.get(v, 0) for v in range(V)}

    def timed(eng, feed):
        eng.feed(feed)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adv = eng.advance()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_block(adv.block, S["n_vns"] * S["n_cns"], "stream advance")
        return adv, wall, launch_counts()

    def check(what, launches, want):
        if launches != want:
            raise SystemExit(f"stream {what}: launches {launches} differ "
                             f"from {want}")

    eng = mk("hl", ProofDB(db_path))
    torch.cuda.synchronize()
    print(f"phase 12 setup: cluster and {W + 3} panes of {PW} rows a DP, "
          f"{time.perf_counter() - t0:.1f} s, the engine's "
          f"{warm_s(eng.timers)}", flush=True)
    kept.tag = "12"
    with kept:
        a0, fill_s, l0 = timed(eng, {n: r[:W].reshape(-1)
                                     for n, r in rows.items()})
    check("fill", l0, stream_launches(W, W, 2 * W, payload_proofs, None))
    if a0.window != (0, W - 1) or a0.result != truth(0, W):
        raise SystemExit(f"stream fill: window {a0.window}, result differs")
    c0 = dict(eng.counters)
    a1, adv_s, l1 = timed(eng, {n: r[W] for n, r in rows.items()})
    check("1-pane advance", l1, stream_launches(1, 1, 2, payload_proofs, 2))
    made = {k: eng.counters[k] - c0[k] for k in c0}
    if ((a1.panes_new, a1.panes_expired) != (1, 1)
            or made["proofs_created"] != S["n_dps"]
            or made["pane_verifies"] != S["n_dps"]
            or set(k.split("/")[1] for k in a1.block.data.bitmap)
            != {"aggregation"}):
        raise SystemExit(f"steady advance: {a1.panes_new} new, "
                         f"{a1.panes_expired} expired, counters {made}")
    a2, adv2_s, l2 = timed(eng, {n: r[W + 1:W + 3].reshape(-1)
                                 for n, r in rows.items()})
    check("2-pane advance", l2, stream_launches(2, 2, 4, payload_proofs, 4))
    first, last = a2.window
    if (first, last) != (3, W + 2) or a2.result != truth(3, W + 3):
        raise SystemExit(f"stream 2-pane advance: window {a2.window}, "
                         f"result differs from the clear counts")
    window_bytes = eng.window_ct.cpu().numpy().tobytes()
    scratch_fold = topo.fold_cts(torch.stack(
        [eng._panes[i].fold for i in range(first, last + 1)]))
    if scratch_fold.cpu().numpy().tobytes() != window_bytes:
        raise SystemExit("the delta window differs from a from-scratch fold "
                         "of its panes")
    for p in eng._panes:
        check_block(p.block, S["n_vns"] * S["n_dps"], f"pane {p.pane_id}")
    dig = transcript_digest(cluster.vns, a2.survey_id)
    pane_digs = [transcript_digest(cluster.vns, eng.pane_sid(p))
                 for p in range(last + 1)]
    seal_s = (dict(eng.timers.items())["PaneSeal"]
              / eng.counters["panes_sealed"])
    print(f"phase 12: filled {W} panes in {fill_s:.3f} s; advance by 1 pane "
          f"{adv_s:.4f} s (2 proofs made and checked, {S['n_cns']} "
          f"aggregation envelopes), by 2 panes {adv2_s:.4f} s; launches of "
          f"the 1-pane advance {l1}", flush=True)

    # the from-scratch control: a cold stream id fed every row
    sc = mk("hl-scratch")
    s1, scratch_s, ls = timed(sc, {n: r.reshape(-1) for n, r in rows.items()})
    check("scratch", ls, stream_launches(W + 3, W + 3, 2 * (W + 3),
                                         payload_proofs, None))
    if (s1.result != a2.result or s1.window != a2.window
            or sc.window_ct.cpu().numpy().tobytes() != window_bytes
            or s1.decrypted.values.tobytes() != a2.decrypted.values.tobytes()):
        raise SystemExit("the from-scratch control differs from the delta "
                         "advance")
    for p in sc._panes:
        check_block(p.block, S["n_vns"] * S["n_dps"], f"scratch pane")

    # a restarted engine on the same stream id with the ProofDB
    rs = mk("hl", ProofDB(db_path))
    r1, restart_s, lr_ = timed(rs, {n: r.reshape(-1) for n, r in rows.items()})
    check("restart", lr_, stream_launches(W + 3, 0, 0, payload_proofs, None,
                                          agg_checked=False))
    if (rs.counters["proofs_created"] != 0
            or rs.counters["proofs_reused"] != S["n_dps"] * (W + 3)
            or r1.survey_id != a2.survey_id or r1.result != a2.result
            or rs.window_ct.cpu().numpy().tobytes() != window_bytes
            or r1.decrypted.values.tobytes() != a2.decrypted.values.tobytes()
            or transcript_digest(cluster.vns, r1.survey_id) != dig
            or [transcript_digest(cluster.vns, rs.pane_sid(p))
                for p in range(last + 1)] != pane_digs):
        raise SystemExit(f"the restarted engine differs: counters "
                         f"{rs.counters}")
    for p in rs._panes:
        check_block(p.block, S["n_vns"] * S["n_dps"], f"restarted pane")
    print(f"  result = the clear counts of panes {first}..{last} ("
          f"{W * PW} rows a DP); the delta window's bytes = a from-scratch "
          f"fold = the cold control's; every block all BM_TRUE; a restarted "
          f"engine reused {rs.counters['proofs_reused']} blobs and "
          f"reproduced the advance's bytes, transcript {dig[:16]} and all "
          f"{last + 1} pane transcripts ({restart_s:.3f} s)", flush=True)
    print(f"phase 12: pane seal {seal_s:.4f} s a pane (mean of "
          f"{eng.counters['panes_sealed']}); advance by 1 pane {adv_s:.4f} s; "
          f"from scratch over {W + 3} panes {scratch_s:.3f} s; ratio "
          f"{scratch_s / adv_s:.2f}; engine timers: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in eng.timers.items()),
          flush=True)
    cluster.close()
    tmp.cleanup()
    return l1, [adv_s]


def phase13(zero_launches, launch_counts):
    """The standing server and its load on the card: (a) chip_smoke's
    LOAD surveys through `SurveyServer` at one and at two verify workers,
    each on a fresh cluster; (b) a closed loop of proofs-off surveys from
    two tenants through `LoadGen` on the second; (c) `precompile(BENCH)`
    on the warm process. Returns (launches of (a) and (b), [(a)'s wall
    times, (b)'s]."""
    from drynx_tpu_torch import compilecache as cc
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.server import SurveyServer, pipeline_overlap
    from drynx_tpu_torch.server.loadgen import LoadGen, ShapeMix
    from drynx_tpu_torch.server.transcript import transcript_digest
    from drynx_tpu_torch.service.service import LocalCluster

    S = LOAD
    sids = ("s0", "s1", "s2")

    def boot():
        cl = LocalCluster(n_cns=S["n_cns"], n_dps=S["n_dps"],
                          n_vns=S["n_vns"], seed=S["seed"],
                          dlog_limit=S["dlog"])
        rng = np.random.default_rng(S["data_seed"])
        for dp in cl.dps.values():
            dp.data = rng.integers(0, 4, size=(S["rows"],)).astype(np.int64)
        return cl

    def queries(cl):
        return [cl.generate_survey_query("sum", 0, S["qmax"], proofs=1,
                                         ranges=[r], survey_id=sid)
                for sid, r in zip(sids, S["ranges"])]

    def digits(r):
        return S["n_dps"] * r[1] * S["n_cns"]

    # s0 and s1 held and flushed together, s2 alone
    p0, p2 = digits(S["ranges"][0]), digits(S["ranges"][2])
    want_a = survey_launches(p2, signed_offset=False)
    add_launches(want_a, {k: v - verify_launches(p0).get(k, 0) for k, v in
                          survey_launches(p0, signed_offset=False).items()},
                 2)
    add_launches(want_a, verify_launches(2 * p0))

    digests, walls, keep = {}, [], None
    for workers in (1, 2):
        t0 = time.perf_counter()
        cl = boot()
        srv = SurveyServer(cl, max_batch=3, pipeline=True, workers=workers)
        sqs = queries(cl)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        mark = cc.COLD_EVENTS.mark()
        t0 = time.perf_counter()
        pre = srv.prewarm(sqs[0])
        prewarm_s = time.perf_counter() - t0
        builds = dict(rp.SIG_BUILD_COUNTS)
        zero_launches()
        t0 = time.perf_counter()
        lanes = [srv.submit(sq).lane for sq in sqs]
        out = srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        events = cc.COLD_EVENTS.since(mark)
        clear = sum(int(d.data.sum()) for d in cl.dps.values())
        flushes = [n for n, _, _ in srv.timers.spans("Pipeline.flush.")]
        overlap = pipeline_overlap(srv.timers)
        timeline = ", ".join(f"{n} {a - t0:.3f}-{b - t0:.3f}"
                             for n, a, b in sorted(srv.timers.spans(),
                                                   key=lambda x: x[1]))
        off = [e for e in events if e[2] != "MainThread"]
        if (pre.lane != "fast" or lanes != ["fast", "fast", "fast"]
                or flushes != ["Pipeline.flush.s0+s1"]):
            raise SystemExit(f"13a (workers={workers}): prewarm {pre.lane}, "
                             f"lanes {lanes}, flushes {flushes}")
        for sid in sids:
            res = out[sid]
            if isinstance(res, Exception) or int(res.result) != clear:
                raise SystemExit(f"13a: survey {sid} gave {res!r}, clear "
                                 f"sum {clear}")
            check_block(res.block, S["n_vns"] * (S["n_dps"]
                                                 + 2 * S["n_cns"]),
                        f"13a survey {sid}")
        if off or dict(rp.SIG_BUILD_COUNTS) != builds:
            raise SystemExit(f"13a: cold work off the drain thread {off}, "
                             f"table builds {builds} -> "
                             f"{rp.SIG_BUILD_COUNTS} inside the surveys")
        if launches != want_a:
            raise SystemExit(f"13a launches {launches} differ from {want_a}")
        digests[workers] = {sid: transcript_digest(cl.vns, sid)
                            for sid in sids}
        walls.append(wall)
        print(f"phase 13a (workers={workers}): cluster {boot_s:.2f} s, "
              f"prewarm(s0) {prewarm_s:.3f} s (the compile lane); s0, s1 "
              f"fast and flushed together, s2 fast (no cold entry) and "
              f"alone; the three surveys {wall:.3f} s, pipeline overlap "
              f"{overlap:.3f} s; results = the clear sum {clear}, blocks "
              f"all BM_TRUE; cold events {len(events)}, all on the drain "
              f"thread; launches {launches}\n  spans (s from submit): "
              f"{timeline}", flush=True)
        if keep is not None:
            keep.close()
        keep = cl
    if digests[1] != digests[2]:
        raise SystemExit(f"13a: transcripts differ across worker counts: "
                         f"{digests}")
    print(f"  transcripts equal at 1 and 2 workers: "
          f"{ {s: d[:16] for s, d in digests[2].items()} }", flush=True)

    # (b) a closed loop on the two-worker cluster: proofs-off surveys
    cl = keep
    clear = np.concatenate([d.data for d in cl.dps.values()])
    truth = {"sum": int(clear.sum()), "mean": float(clear.mean())}
    srv = SurveyServer(cl, max_batch=4, pipeline=True, workers=2)
    shapes = [ShapeMix("sum", proofs=0), ShapeMix("mean", proofs=0)]
    lg = LoadGen(srv, shapes=shapes, tenants={"t0": 1.0, "t1": 1.0},
                 seed=13, query_fn=lambda sid, shape:
                 cl.generate_survey_query(shape.name, 0, S["qmax"], proofs=0,
                                          survey_id=sid))
    zero_launches()
    t0 = time.perf_counter()
    rep = lg.run_closed(concurrency=S["concurrency"], n_total=S["total"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches_b = launch_counts()
    out = srv.results()
    r = rep["rejected"]
    if (rep["lost"] or rep["errors"] or rep["completed"] != S["total"]
            or rep["offered"] != rep["completed"] + sum(r.values())):
        raise SystemExit(f"13b accounting: {rep}")
    wrong = {rec.survey_id: out[rec.survey_id].result for rec in lg.records
             if rec.outcome == "ok"
             and out[rec.survey_id].result != truth[rec.shape]}
    if wrong:
        raise SystemExit(f"13b answers {wrong}, clear {truth}")
    want_b = {k: v * S["total"] for k, v in PROOFS_OFF_LAUNCHES.items()}
    if launches_b != want_b:
        raise SystemExit(f"13b launches {launches_b} differ from {want_b}")
    lat = rep["latency_s"]
    print(f"phase 13b: closed loop, concurrency {S['concurrency']}, "
          f"{S['total']} proofs-off sum and mean surveys from 2 tenants: "
          f"offered {rep['offered']}, completed {rep['completed']}, rejected "
          f"{r}, lost {rep['lost']}; every answer = the clear one; "
          f"{load_s:.3f} s, throughput {rep['throughput_sps']} surveys/s, "
          f"latency p50 {lat['p50']} s, p90 {lat['p90']} s, p99 {lat['p99']}"
          f" s, max {lat['max']} s; per tenant {rep['per_tenant']}; "
          f"launches {launches_b}", flush=True)
    cl.close()

    # (c) the warm-up of the reference's bench profile on the warm process
    t0 = time.perf_counter()
    stats = cc.precompile(cc.BENCH, stats=cc.CompileStats(),
                          log=lambda m: None)
    t = stats.totals()
    n_kernels = sum(1 for e in cc.build_registry(cc.BENCH)
                    if e.kind == "kernel")
    print(f"phase 13c: precompile(BENCH) on the warm process "
          f"{time.perf_counter() - t0:.3f} s:\n{stats.table()}", flush=True)
    if (t["errors"] or t["loaded"] != len(cc.registry.LIBRARIES)
            or t["executed"] != n_kernels + 1):
        raise SystemExit(f"13c: {t}")
    return add_launches(dict(want_a), launches_b), walls + [load_s]


@contextlib.contextmanager
def fault_plan_installed(plan):
    """`plan` as the port's process-wide fault plan for the body; cleared
    afterwards, whatever the body does."""
    from drynx_tpu_torch.resilience import faults

    faults.set_fault_plan(plan)
    try:
        yield plan
    finally:
        faults.set_fault_plan(None)


def phase14a(cluster, stats, params, zero_launches, launch_counts,
             timers7):
    """Phase 7's survey on `cluster` (phase 7's configuration) with dp9 and
    vn2 killed: the nine responders' survey and a block from vn0 and vn1;
    then a query asking for all ten DPs, refused. Returns (launches,
    [wall time])."""
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.resilience import faults

    t0 = time.perf_counter()
    V = stats.shape[1]
    n_resp = NUM_DPS - 1
    sq = cluster.generate_survey_query(
        "log_reg", proofs=1, lr_params=params, ranges=[(U, L)] * V,
        thresholds=1.0, min_dp_quorum=DEGRADED_QUORUM,
        vn_quorum=DEGRADED_VN_QUORUM)
    strict = cluster.generate_survey_query(
        "log_reg", proofs=1, lr_params=params, ranges=[(U, L)] * V,
        thresholds=1.0, min_dp_quorum=NUM_DPS)
    digit_proofs = n_resp * V * L * N_SERVERS
    clear = stats[:n_resp].sum(0).cpu().numpy()
    plan = faults.FaultPlan(seed=0)
    for name in DEGRADED_KILLED:
        plan.kill(name)
    checks, batch_verify = [], rp.verify_range_proofs_batch

    def counted(pb, *a, **k):
        checks.append(pb.n_values * pb.l * pb.n_servers)
        return batch_verify(pb, *a, **k)

    print(f"phase 14a setup: {plan.describe()}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for vn in cluster.vns.vns:
        vn.verify_cache.clear()
    with fault_plan_installed(plan):
        rp.verify_range_proofs_batch = counted
        try:
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cluster.run_survey(sq, seed=SURVEY_SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            rp.verify_range_proofs_batch = batch_verify
        try:
            cluster.run_survey(strict, seed=SURVEY_SEED)
            refused = None
        except RuntimeError as e:
            refused = str(e)
    if faults.fault_plan() is not None:
        raise SystemExit("the fault plan outlived phase 14a")
    absent = [n for n in DEGRADED_KILLED if n.startswith("dp")]
    want_refusal = (f"survey {strict.survey_id}: only {n_resp}/{NUM_DPS} "
                    f"DPs responded (quorum {NUM_DPS}); absent: {absent}")
    if refused != want_refusal:
        raise SystemExit(f"the ten-DP query: {refused!r}, not the quorum "
                         f"refusal")
    want_resp = [f"dp{i}" for i in range(n_resp)]
    if res.responders != want_resp or res.absent != absent:
        raise SystemExit(f"responders {res.responders}, absent {res.absent}")
    if (not res.decrypted.found.all()
            or not np.array_equal(res.decrypted.values, clear)):
        raise SystemExit("the degraded survey's decrypted aggregate differs "
                         "from the responders' clear sums")
    err, tol = lr_weights_ok(res, params, "degraded survey")
    bitmap = res.block.data.bitmap
    check_block(res.block, 2 * (n_resp + 2 * N_SERVERS), "degraded survey")
    if {k.split(":")[0] for k in bitmap} != {"vn0", "vn1"}:
        raise SystemExit(f"the degraded block's VNs: "
                         f"{sorted({k.split(':')[0] for k in bitmap})}")
    if checks != [digit_proofs]:
        raise SystemExit(f"digit proofs checked {checks}, want "
                         f"[{digit_proofs}]")
    want = survey_launches(digit_proofs, signed_offset=True)
    if launches != want:
        raise SystemExit(f"degraded survey launches {launches} differ from "
                         f"{want}")
    if res.resumes != 0 or set(res.phases.values()) != {1}:
        raise SystemExit(f"resumes {res.resumes}, phases {res.phases}")
    print(f"  responders dp0..dp{n_resp - 1}, absent {absent}; decrypted = "
          f"the {n_resp} responders' clear sums; weights max abs err vs CPU GD "
          f"{err:.3g} (tolerance {tol:.3g}); block of {len(bitmap)} entries "
          f"from vn0 and vn1, all BM_TRUE; {checks[0]} digit proofs checked "
          f"in one RLC check; phases {res.phases}, resumes {res.resumes}; "
          f"the ten-DP query refused: {refused}", flush=True)
    print(f"phase 14a: degraded survey wall time {wall:.4f} s (warm "
          f"cluster); launches {launches}; phase timers: "
          + phase_timers([res]), flush=True)
    print(f"phase 14a: phase 7's timers beside them: {timers7}", flush=True)
    return launches, [wall]


def phase14b(zero_launches, launch_counts):
    """A proofs-off sum on phase 13's transcript cluster through
    `SurveyServer`, its checkpoints in a durable store: a one-shot refused
    connect to dp1 fails the first dispatch's quorum, the resume lane
    re-probes and re-enters once, and the result equals an undisturbed
    run's. Returns (launches, [wall time])."""
    import tempfile

    from drynx_tpu_torch.resilience import faults
    from drynx_tpu_torch.resilience.policy import RESUME_BACKOFF_S
    from drynx_tpu_torch.server import SurveyServer
    from drynx_tpu_torch.service.service import LocalCluster
    from drynx_tpu_torch.service.store import ProofDB, SurveyCheckpoint

    S = LOAD
    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=S["n_cns"], n_dps=S["n_dps"],
                           n_vns=S["n_vns"], seed=S["seed"],
                           dlog_limit=S["dlog"])
    rng = np.random.default_rng(S["data_seed"])
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, 4, size=(S["rows"],)).astype(np.int64)
    tmp = tempfile.TemporaryDirectory(prefix="drynx_ckpt_")
    cluster.attach_checkpoint_store(f"{tmp.name}/ckpt.db")
    clear = sum(int(d.data.sum()) for d in cluster.dps.values())

    def query(sid):
        return cluster.generate_survey_query("sum", 0, S["qmax"], proofs=0,
                                             survey_id=sid)

    def serve(sid):
        srv = SurveyServer(cluster, pipeline=False)
        srv.submit(query(sid))
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.drain()[sid]
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, launch_counts()

    baseline, base_s, _ = serve("r0")
    print(f"phase 14b setup: cluster and an undisturbed run "
          f"{time.perf_counter() - t0 - base_s:.1f} s + {base_s:.3f} s",
          flush=True)
    plan = faults.FaultPlan(seed=0)
    plan.add(faults.FaultSpec(where="connect", kind="refuse", target="dp1",
                              count=1))
    with fault_plan_installed(plan):
        res, wall, launches = serve("r1")
    if isinstance(res, Exception):
        raise SystemExit(f"the resumed survey failed: {res!r}")
    stored = SurveyCheckpoint.load(ProofDB(f"{tmp.name}/ckpt.db"), "r1")
    tmp.cleanup()
    cluster.close()
    if (res.result != baseline.result or int(res.result) != clear
            or res.responders != ["dp0", "dp1"] or res.absent != []):
        raise SystemExit(f"resumed survey: {res.result} over "
                         f"{res.responders} (absent {res.absent}), the "
                         f"undisturbed run {baseline.result}")
    if (res.resumes != 1 or res.phases.get("probe") != 2
            or {k: v for k, v in res.phases.items() if k != "probe"}
            != {k: 1 for k in baseline.phases if k != "probe"}
            or stored is None or stored.resumes != 1 or not stored.done
            or stored.phase_entries != res.phases):
        raise SystemExit(f"resume record: resumes {res.resumes}, phases "
                         f"{res.phases}, from the store {stored}")
    if plan.specs[0].fired != 1 or launches != PROOFS_OFF_LAUNCHES:
        raise SystemExit(f"the refusal fired {plan.specs[0].fired} times; "
                         f"launches {launches}")
    print(f"  the first dispatch refused (dp1's connect), re-probed and "
          f"re-entered once: result {res.result} = the undisturbed run's = "
          f"the clear sum, responders {res.responders}, absent "
          f"{res.absent}; phases {res.phases}, resumes {res.resumes}, the "
          f"same record read back from the reopened store", flush=True)
    print(f"phase 14b: resumed survey wall time {wall:.4f} s (the resume "
          f"lane's {RESUME_BACKOFF_S} s backoff in it) against "
          f"{base_s:.4f} s undisturbed; launches {launches}", flush=True)
    return launches, [wall]


def phase14c(X, params, w, zero_launches, launch_counts, kept=None):
    """The encrypted prediction: the Pima records rounded to integers,
    encrypted under the querier's key of phase 7's cluster configuration,
    scored with the weights `w` through `logreg.predict_homomorphic`,
    counted; the G1 kernels' calls kept (in `kept`, held with phases
    10-12's, or held here) against their plain versions. Returns
    (launches, [wall time])."""
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.service.service import LocalCluster

    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=NUM_DPS, n_vns=0,
                           seed=CLUSTER_SEED, dlog_limit=DLOG_LIMIT)
    dev = cluster.device
    Xi = np.round(X[:PREDICT_RECORDS]).astype(np.int64)   # (768, 8)
    means, stds = params.means, params.std_devs
    gen = torch.Generator(device=dev).manual_seed(PREDICT_SEED)
    r = eg.random_scalars(Xi.shape, gen, dev)
    cts = eg.encrypt_ints_with_tables(cluster.base_table,
                                      cluster.client_tbl.table,
                                      torch.from_numpy(Xi).to(dev), r)
    P = PREDICT_PRECISION
    w0p, wp = lr.fold_affine(w, means, stds)
    wi, w0i = [int(round(P * v)) for v in wp], int(round(P * w0p))
    want = [sum(wi[j] * int(x[j]) for j in range(len(wi))) + w0i
            for x in Xi.tolist()]
    if max(abs(m) for m in want) > cluster.dlog.limit:
        raise SystemExit("a margin lies outside the decryption table")
    torch.cuda.synchronize()
    print(f"phase 14c setup: {Xi.shape[0]} records x {Xi.shape[1]} integer "
          f"features encrypted under the querier's key, margins within "
          f"+-{max(abs(m) for m in want)}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    own = kept is None
    if own:
        kept = KeptCalls(KeptCalls.G1)
    kept.tag = "14c"
    decrypted = {}
    decrypt_ints = eg.decrypt_ints

    def recorded(*a, **k):
        decrypted["v"] = decrypt_ints(*a, **k)
        return decrypted["v"]

    eg.decrypt_ints = recorded
    try:
        with kept:
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probs, preds, found = lr.predict_homomorphic(
                cts, w, cluster.client.secret, cluster.dlog, means, stds, P)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        eg.decrypt_ints = decrypt_ints
    cluster.close()
    margin = decrypted["v"][0].cpu().tolist()
    clear = lr.predict_probs(Xi, w, means, stds).numpy()
    probs = probs.cpu().numpy()
    if not bool(found.all()) or margin != want:
        raise SystemExit(f"decrypted margins differ from the integer "
                         f"formula at {sum(a != b for a, b in zip(margin, want))}"
                         f" records (found {int(found.sum())})")
    err = float(np.abs(probs - clear).max())
    if err > 0.02 or not np.array_equal(preds.cpu().numpy(),
                                        (probs >= 0.5).astype(np.int64)):
        raise SystemExit(f"encrypted probabilities differ from the clear "
                         f"ones by {err}")
    if launches != {**dict.fromkeys(launches, 0), **PREDICT_LAUNCHES}:
        raise SystemExit(f"encrypted prediction launches {launches} differ "
                         f"from {PREDICT_LAUNCHES}")
    held = "kept, held with phases 10-12's"
    if own:
        t0 = time.perf_counter()
        calls = kept.hold()
        held = (f"byte-equal to their plain versions "
                f"({time.perf_counter() - t0:.1f} s): {calls}")
    print(f"  {len(want)} margins = sum_j round(P w'_j) x_j + round(P w0') "
          f"exactly, all found; probabilities within {err:.3g} of the clear "
          f"ones (tolerance 0.02); accuracy of the encrypted predictions "
          f"against the clear ones "
          f"{lr.accuracy(probs >= 0.5, clear >= 0.5):.4f}; the G1 kernels' "
          f"calls at these sizes {held}", flush=True)
    print(f"phase 14c: encrypted prediction of {len(want)} records "
          f"{wall:.4f} s; launches {launches}", flush=True)
    return launches, [wall]


def widen_on_card_ok():
    """The card's widen of every narrowed wire segment (each of
    transport.widen_pairs(), at the device decode's floor and below)
    equals the host's, bit for bit. Returns the pairs checked."""
    from drynx_tpu_torch.service import transport as tr

    floor = tr.DEVICE_DECODE_MIN_BYTES
    for narrow, wide in tr.widen_pairs():
        info = np.iinfo(np.dtype(narrow))
        for n in (floor // np.dtype(narrow).itemsize + 5, 7):
            a = np.random.default_rng(n).integers(
                info.min, int(info.max) + 1, size=n).astype(wide)
            a[:2] = [info.min, info.max]
            d = tr.decode_frame(tr.encode_frame({"a": tr.pack_array(a)},
                                                2)[4:], 2)["a"]
            got = tr.unpack_array_device(d, "cuda")
            if (not isinstance(d["data"], tr.LazySeg)
                    or d["data"].wire_dt != narrow
                    or got.device.type != "cuda"
                    or got.dtype != getattr(torch, wide)
                    or not np.array_equal(got.cpu().numpy(), a)):
                raise SystemExit(f"the card's widen {narrow} -> {wide} at "
                                 f"{n} values differs from the host's")
    return len(tr.widen_pairs())


def phase15a(stats, X, y, params, zero_launches, launch_counts, res7=None,
             wall7=None):
    """Phase 7's survey over TCP: 16 DrynxNodes on 127.0.0.1 in this
    process (3 CNs, 10 DPs holding phase 7's Pima shards, 3 VNs) driven
    by a RemoteClient, proofs on, ranges (16, 5): a cold survey, a warm
    one over the tree overlay and a warm one over the star, each held to
    phase 7's integers and weights (`res7`; GD on the clear sums without
    it). Returns (the warm tree run's launches, [its wall time])."""
    import os
    import tempfile

    from drynx_tpu_torch.compilecache.stats import COLD_EVENTS
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.proofs import requests as rq
    from drynx_tpu_torch.resilience import policy as pol
    from drynx_tpu_torch.service import topology as topo
    from drynx_tpu_torch.service import transport as tr
    from drynx_tpu_torch.service.node import (DrynxNode, RemoteClient,
                                              Roster, RosterEntry)
    from drynx_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    pairs = widen_on_card_ok()
    rng = np.random.default_rng(CLUSTER_SEED)
    tmp = tempfile.TemporaryDirectory(prefix="drynx_tcp_")
    nodes, entries = [], []
    for role, n in (("cn", N_SERVERS), ("dp", NUM_DPS), ("vn", N_VNS)):
        for i in range(n):
            name = f"{role}{i}"
            x, pub = eg.keygen(rng)
            node = DrynxNode(name, x, pub, db_path=f"{tmp.name}/{name}.db",
                             data=(lr.shard_for_dp(X, y, i, NUM_DPS)
                                   if role == "dp" else None))
            node.start()
            nodes.append(node)
            entries.append(RosterEntry(name=name, role=role,
                                       host=node.address[0],
                                       port=node.address[1], public=pub))
    client = RemoteClient(Roster(entries), rng)
    client.broadcast_roster()
    dlog = eg.DecryptionTable(limit=DLOG_LIMIT).to("cuda")
    V = stats.shape[1]
    clear = stats.sum(0).cpu().numpy()
    w_ref = (torch.from_numpy(res7.result) if res7 is not None else
             lr.train(lr.unpack(stats.sum(0).cpu(), params), params))
    fanout = topo.tree_fanout(NUM_DPS)
    want_entries = N_VNS * client.expected_proofs(NUM_DPS, N_SERVERS,
                                                  False, False)
    print(f"phase 15a setup: the card's widen equals the host's on all "
          f"{pairs} widen pairs; {len(nodes)} nodes on 127.0.0.1 (tree "
          f"fanout {fanout}, roots {topo.roots(NUM_DPS, fanout)}), the "
          f"discrete-log table {time.perf_counter() - t0:.1f} s", flush=True)

    def run(sid, mode):
        os.environ[topo.ENV_TOPOLOGY] = mode
        tr.WIRE_TIMERS.clear()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            w, block = client.run_survey(
                "log_reg", lr_params=params, proofs=True,
                ranges=[(U, L)] * V, survey_id=sid, dlog=dlog,
                timeout=pol.COLD_COMPILE_WAIT_S)
        finally:
            os.environ.pop(topo.ENV_TOPOLOGY, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        rows = {k: dict(v) for k, v in cuda_build.LAUNCH_ROWS.items() if v}
        dec = client.last_decrypted
        if not dec.found.all() or not np.array_equal(dec.values, clear):
            raise SystemExit(f"TCP survey {sid}: the decrypted aggregate "
                             f"differs from phase 7's integers")
        err = float((torch.from_numpy(w) - w_ref).abs().max())
        if w.shape != (D + 1,) or not np.isfinite(w).all() or err > 1e-3:
            raise SystemExit(f"TCP survey {sid}: weights differ from phase "
                             f"7's by {err}")
        bitmap = block["bitmap"]
        if (len(bitmap) != want_entries
                or set(bitmap.values()) != {rq.BM_TRUE}):
            raise SystemExit(f"TCP survey {sid}: block of {len(bitmap)} "
                             f"entries (want {want_entries}), codes "
                             f"{sorted(set(bitmap.values()))}")
        if client.last_responders != [f"dp{i}" for i in range(NUM_DPS)]:
            raise SystemExit(f"TCP survey {sid}: responders "
                             f"{client.last_responders}")
        return wall, launches, rows, err, dict(client.last_net)

    mark = COLD_EVENTS.mark()
    cold_s = run("tcp-cold", "tree")[0]
    by_thread = {}
    for kind, name, thread in COLD_EVENTS.since(mark):
        by_thread.setdefault(thread, []).append(f"{kind}:{name}")
    print(f"phase 15a: cold TCP survey {cold_s:.3f} s; cold events by "
          f"thread: {by_thread}", flush=True)
    out = {}
    for mode in ("tree", "star"):
        wall, launches, rows, err, net = run(f"tcp-{mode}", mode)
        want, want_rows = tcp_survey_launches(
            N_SERVERS, NUM_DPS, N_VNS, V, L, mode, fanout, True)
        by_kernel = {}
        for (k, n), c in want_rows.items():
            by_kernel.setdefault(k, {})[n] = c
        if launches != want or rows != by_kernel:
            raise SystemExit(f"TCP survey ({mode}): launches {launches} "
                             f"(want {want}), rows {rows} (want "
                             f"{by_kernel})")
        glue = tr.WIRE_TIMERS.split_summary()["host_glue_s"]
        out[mode] = (wall, launches, net)
        print(f"phase 15a: warm TCP survey over the {mode} {wall:.3f} s; "
              f"decrypted = phase 7's integers, weights max abs err vs "
              f"phase 7's {err:.3g}, block of {want_entries} entries all "
              f"BM_TRUE; launches and rows = the roster's count "
              f"{launches}; bytes received by the root cn0 "
              f"{net['rx_by_node'].get('cn0')}, in all "
              f"{net['bytes_total']} in {net['msgs_total']} frames; wire "
              f"timers {dict(tr.WIRE_TIMERS.items())}, host glue {glue} s "
              f"(the wire's card side is not timed)", flush=True)
        if mode == "tree":
            print(f"phase 15a: launch rows of the warm tree run "
                  f"{dict(sorted(rows.items()))}", flush=True)
    print(f"phase 15a: wall times cold {cold_s:.3f} s, warm tree "
          f"{out['tree'][0]:.3f} s, warm star {out['star'][0]:.3f} s; "
          f"phase 7's warm LocalCluster survey "
          f"{'not run' if wall7 is None else f'{wall7:.3f} s'}; root "
          f"bytes tree {out['tree'][2]['rx_by_node'].get('cn0')} vs star "
          f"{out['star'][2]['rx_by_node'].get('cn0')}", flush=True)
    for n in nodes:
        n.stop()
    tr.set_conn_pool(None)
    tmp.cleanup()
    return out["tree"][1], [out["tree"][0]]


# the shell scenarios of test/client_run-survey (1 CN, 2 DPs holding 1..5
# and 10..14: sum 75) and test/client_run-survey-proofs (2 CNs, 1 DP
# holding 1..5, 1 VN, proofs on: sum 15 and a clean bitmap), each node a
# `python -m drynx_tpu_torch.cmd.server run` process on the card
CLI_SCENARIOS = {
    "client_run-survey": (("cn0", "dp1", "dp2"), False, 75),
    "client_run-survey-proofs": (("cn0", "cn1", "dp1", "vn0"), True, 15),
}
CLI_DATA = {"dp1": range(1, 6), "dp2": range(10, 15)}


class CliNodes:
    """The server processes of CLI_SCENARIOS: `server gen` for every node
    (all at once), then `server run` for every node on the card, started
    on entering (so they boot while phase 15a runs) and killed on exit,
    whatever failed."""

    def __init__(self):
        import os

        # each server's listening line and its seconds from the start of
        # the servers, as a watcher thread sees them appear
        self.lines, self.up = {}, {}
        root = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = root + (os.pathsep + self.env["PYTHONPATH"]
                                         if self.env.get("PYTHONPATH")
                                         else "")
        self.procs, self.logs, self.addrs, self.cfgs = {}, {}, {}, {}
        self.server = [sys.executable, "-m", "drynx_tpu_torch.cmd.server"]

    def __enter__(self):
        import os
        import socket
        import subprocess
        import tempfile

        self.tmp = tempfile.TemporaryDirectory(prefix="drynx_cli_")
        try:
            keys = [(sc, n) for sc, (nodes, _, _) in CLI_SCENARIOS.items()
                    for n in nodes]
            for key in keys:
                s = socket.socket()
                s.bind(("127.0.0.1", 0))
                self.addrs[key] = f"127.0.0.1:{s.getsockname()[1]}"
                s.close()
            gens = {key: subprocess.Popen(
                self.server + ["gen", "--address", self.addrs[key],
                               "--name", key[1]],
                stdout=subprocess.PIPE, text=True, env=self.env)
                for key in keys}
            for key, g in gens.items():
                self.cfgs[key] = g.communicate(timeout=300)[0]
                if g.returncode != 0:
                    raise SystemExit(f"{key}: server gen exited "
                                     f"{g.returncode}")
            self.t0 = time.perf_counter()
            for (sc, n) in keys:
                path = os.path.join(self.tmp.name, f"{sc}-{n}")
                with open(path + ".toml", "w") as f:
                    f.write(self.cfgs[(sc, n)])
                extra = []
                if n in CLI_DATA:
                    np.savetxt(path + ".data", np.asarray(CLI_DATA[n]),
                               fmt="%d")
                    extra = ["--data", path + ".data"]
                if n.startswith("vn"):
                    extra = ["--db", path + ".db"]
                self.logs[(sc, n)] = path + ".log"
                with open(path + ".toml") as fin, \
                        open(path + ".log", "w") as ferr:
                    self.procs[(sc, n)] = subprocess.Popen(
                        self.server + ["run"] + extra, stdin=fin,
                        stderr=ferr, stdout=subprocess.DEVNULL,
                        env=self.env)
            threading.Thread(target=self._watch, daemon=True).start()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        for p in self.procs.values():
            p.kill()
        for p in self.procs.values():
            p.wait(timeout=60)
        self.tmp.cleanup()
        return False

    def _watch(self):
        """Note each server's listening line when it appears."""
        while (len(self.lines) < len(self.procs)
               and time.perf_counter() - self.t0 < 300):
            for key, log in self.logs.items():
                if key not in self.lines:
                    text = open(log).read()
                    if "listening" in text:
                        self.up[key] = time.perf_counter() - self.t0
                        self.lines[key] = text.strip().splitlines()[-1]
            time.sleep(0.05)

    def listening(self, sc):
        """Wait for every server of scenario `sc` to print its listening
        line: ({node: line}, {node: seconds from the servers' start})."""
        nodes = CLI_SCENARIOS[sc][0]
        while not all((sc, n) in self.lines for n in nodes):
            for n in nodes:
                if self.procs[(sc, n)].poll() is not None:
                    raise SystemExit(
                        f"{sc}: server {n} exited "
                        f"{self.procs[(sc, n)].returncode}: "
                        f"{open(self.logs[(sc, n)]).read()}")
            if time.perf_counter() - self.t0 > 300:
                raise SystemExit(f"{sc}: servers never listened")
            time.sleep(0.05)
        return ({n: self.lines[(sc, n)] for n in nodes},
                {n: self.up[(sc, n)] for n in nodes})

    def drive(self, sc):
        """Scenario `sc` through the client pipeline, piped as the script
        pipes it; returns its record, raises SystemExit on a failed
        gate."""
        import subprocess

        from drynx_tpu_torch.cmd import toml_io

        nodes, proofs, want = CLI_SCENARIOS[sc]
        lines, up = self.listening(sc)
        for n, line in lines.items():
            if not line.startswith(f"drynx node {n} listening on "
                                   f"{self.addrs[(sc, n)]} device cuda"):
                raise SystemExit(f"{sc}: server {n} says {line!r}")
        client = f"{sys.executable} -m drynx_tpu_torch.cmd.client"
        stages = [f"{client} network new"]
        for n in nodes:
            node = toml_io.loads(self.cfgs[(sc, n)])["node"]
            stages.append(f"{client} network add-node --role {n[:2]} "
                          f"--address {self.addrs[(sc, n)]} --name {n} "
                          f"--public {node['public_x']},{node['public_y']}")
        stages.append(f"{client} survey new --operation sum --min 0 "
                      f"--max 20" + (" --proofs" if proofs else ""))
        stages.append(f"{client} survey run")
        t1 = time.perf_counter()
        r = subprocess.run(["bash", "-c", "set -o pipefail; "
                            + " | ".join(stages)], capture_output=True,
                           text=True, env=self.env, timeout=600)
        wall = time.perf_counter() - t1
        if r.returncode != 0:
            raise SystemExit(f"{sc}: the client pipeline exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        if out.get("result") != want or (proofs and
                                         out.get("bitmap_ok") is not True):
            raise SystemExit(f"{sc}: {out}, want result {want}"
                             + (" and a clean bitmap" if proofs else ""))
        crashed = {n: self.procs[(sc, n)].returncode for n in nodes
                   if self.procs[(sc, n)].poll() is not None}
        if crashed:
            raise SystemExit(f"{sc}: servers exited under the survey: "
                             f"{crashed}")
        return {"out": out, "listening_s": up, "lines": lines,
                "survey_s": wall}


def phase15b(cli):
    """The CLI's multi-process scenarios on the card (CLI_SCENARIOS, both
    at once) over `cli`'s server processes. Returns {scenario: its
    record}."""
    out, errors = {}, []

    def one(sc):
        try:
            out[sc] = cli.drive(sc)
        except BaseException as e:      # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(sc,))
               for sc in CLI_SCENARIOS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for sc, rec in out.items():
        print(f"phase 15b: {sc}: {rec['out']}; servers' seconds to "
              f"listening (started with phase 15a) "
              f"{{{', '.join(f'{n}: {v:.1f}' for n, v in rec['listening_s'].items())}}}; "
              f"the client pipeline {rec['survey_s']:.1f} s; listening "
              f"lines {list(rec['lines'].values())}", flush=True)
    return out


# the reference-shaped LR datasets of phase 16a (tests/test_lr_datasets.py
# :63-67, :158-163): (name, precision, GD steps) at k = 2, 5 DPs, 3 servers,
# dlog +-40,000; the generated proof payloads' (u, l)
LR_DATASETS = (("pima", 1.0, 450), ("pcs", 0.1, 450), ("spectf", 0.1, 100))
LR_DPS, LR_DLOG, LR_SEED = 5, 40_000, 3
GEN_U, GEN_L = 4, 2
# the runfiles phase 16b runs (their rows: drynx.toml's three sums and
# minmax.toml's 1,000- and 10,000-bucket max)
SIMUL_RUNFILES = ("drynx.toml", "minmax.toml")
# phase 16c: the shard count of the forced plane and the butterfly's
SHARDS_16C, BUTTERFLY_SHARDS = 4, 8
# phase 16d: the port's scenarios run as bash processes on the card (15b
# drives client_run-survey and client_run-survey-proofs itself)
SCENARIOS_16D = ("client_network-new", "server_conf-and-run",
                 "client_run-lr-survey-proofs")


def clear_logreg(X, y, iters=3000, step=0.1, lam=1.0):
    """Exact log-loss GD on standardized features (the reference test's
    clear-text twin, tests/test_lr_datasets.py:_clear_logreg)."""
    Xa = np.concatenate([np.ones((len(y), 1)),
                         (X - X.mean(0)) / (X.std(0) + 1e-12)], axis=1)
    w = np.zeros(Xa.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-Xa @ w))
        g = Xa.T @ (p - y) / len(y) + lam * w / len(y)
        w -= step * g
    return w


def phase16a(zero_launches, launch_counts, expected_launches):
    """The reference-shaped datasets: encrypted LR on Pima, PCS and SPECTF
    through the flagship survey (exact sums, GD against the CPU, the
    reference's quality gates), then `create_random_good_test_data`'s five
    payloads against a cluster of phase 7's configuration. Returns
    (launches, walls)."""
    import os
    import tempfile

    from drynx_tpu_torch import flagship
    from drynx_tpu_torch.data import create_random_good_test_data
    from drynx_tpu_torch.data import datasets
    from drynx_tpu_torch.models import logreg as lr

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    setup = flagship.SurveySetup.create(n_servers=N_SERVERS,
                                        dlog_limit=LR_DLOG, device=dev)
    print(f"phase 16a setup: {N_SERVERS} servers' keys, the querier's and "
          f"the discrete-log table of +-{LR_DLOG} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    total, walls = {}, []
    with tempfile.TemporaryDirectory(prefix="drynx_lr_") as tmp:
        for name, precision, iters in LR_DATASETS:
            X, y = datasets.generate(name, seed=LR_SEED)
            path = os.path.join(tmp, f"{name}.csv")
            datasets.write_csv(path, X, y)
            X2, y2 = lr.load_csv(path)           # the loader path
            if not (np.allclose(X2, X) and np.array_equal(y2, y)):
                raise SystemExit(f"{name}: the CSV read back differs")
            params = lr.LRParams(
                k=2, precision=precision, lambda_=1.0, step=0.1,
                max_iterations=iters, n_features=X2.shape[1],
                n_records=len(y2), dtype="float32",
                means=tuple(np.mean(X2, 0)), std_devs=tuple(np.std(X2, 0)))
            stats, enc_rs, ks_rs = flagship.make_inputs(
                X2, y2, params, LR_DPS, N_SERVERS, device=dev)
            fn = flagship.build_pipeline(setup, params)
            zero_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            w, dec, found = fn(stats, enc_rs, ks_rs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = launch_counts()
            if launches != expected_launches:
                raise SystemExit(f"{name}: launches {launches} differ from "
                                 f"{expected_launches}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            V = stats.shape[1]
            if (dec.shape != (V,) or not bool(found.all())
                    or not torch.equal(dec.cpu().long(),
                                       stats.sum(0).cpu())):
                raise SystemExit(f"{name}: the decrypted aggregate is not the "
                                 f"clear sum of the DPs' statistics")
            w_cpu = lr.train(lr.unpack(dec.cpu(), params), params)
            w_err = float((w.cpu() - w_cpu).abs().max())
            w_tol = 1e-3 * max(1.0, float(w_cpu.abs().max()))
            if not bool(torch.isfinite(w).all()) or w_err > w_tol:
                raise SystemExit(f"{name}: weights differ from CPU GD by "
                                 f"{w_err}")
            w_np = w.cpu().double().numpy()
            acc = lr.accuracy(lr.predict(X2, w_np, params.means,
                                         params.std_devs), y2)
            auc = lr.auc(lr.predict_probs(X2, w_np, params.means,
                                          params.std_devs), y2)
            acc_clear = lr.accuracy(lr.predict(X2, clear_logreg(X2, y2)), y2)
            if acc < 0.6 or auc < 0.6 or acc < acc_clear - 0.1:
                raise SystemExit(f"{name}: accuracy {acc}, AUC {auc}, clear "
                                 f"accuracy {acc_clear}")
            walls.append(wall)
            print(f"phase 16a: {name} {X2.shape[0]} x {X2.shape[1]}, V = {V} "
                  f"a DP, {LR_DPS} DPs: survey {wall:.4f} s (first run); "
                  f"all {V} sums exact and found; weights max abs err vs "
                  f"CPU GD {w_err:.3g} (tolerance {w_tol:.3g}); accuracy "
                  f"{acc:.4f}, AUC {auc:.4f}, clear exact-loss GD's accuracy "
                  f"{acc_clear:.4f}; launches {launches}", flush=True)

    # five generated payloads against a cluster of phase 7's configuration
    from drynx_tpu_torch.proofs import aggregation as agg_proof
    from drynx_tpu_torch.proofs import keyswitch as ks_proof
    from drynx_tpu_torch.proofs import obfuscation as obf_proof
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.proofs import shuffle as shuffle_proof
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.service.service import LocalCluster

    t0 = time.perf_counter()
    cluster = LocalCluster(n_cns=N_SERVERS, n_dps=NUM_DPS, n_vns=N_VNS,
                           seed=CLUSTER_SEED, dlog_limit=DLOG_LIMIT)
    try:
        zero_launches()
        out = create_random_good_test_data(cluster, n_values=2, u=GEN_U,
                                           l=GEN_L, seed=LR_SEED)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_launches = launch_counts()
        for k, v in gen_launches.items():
            total[k] = total.get(k, 0) + v
        tbl = cluster.coll_tbl.table
        sigs_pub = {GEN_U: [s.public for s in cluster.range_sigs[GEN_U]]}
        ranges = [(GEN_U, GEN_L)] * 2
        pr, a, b = safe_loads(out["shuffle"])
        verdicts = {
            "range": rp.verify_range_proof_list(
                rp.RangeProofList.from_bytes(out["range"], dev), ranges,
                sigs_pub, tbl),
            "aggregation": bool(np.all(agg_proof.verify_aggregation_proof(
                safe_loads(out["aggregation"]), dev))),
            "obfuscation": bool(np.all(obf_proof.verify_obfuscation_proofs(
                safe_loads(out["obfuscation"]), dev))),
            "keyswitch": bool(np.all(ks_proof.verify_keyswitch_proofs(
                safe_loads(out["keyswitch"]), cluster.client_tbl.table))),
            "shuffle": shuffle_proof.verify_shuffle(
                pr, torch.from_numpy(a).to(dev), torch.from_numpy(b),
                cluster.coll_pt)}
        bad = rp.RangeProofList.from_bytes(tamper_zv(out["range"]), dev)
        bad_ok = rp.verify_range_proof_list(bad, ranges, sigs_pub, tbl)
    finally:
        cluster.close()
    if verdicts != dict.fromkeys(verdicts, True) or bad_ok is not False:
        raise SystemExit(f"generated payloads: verdicts {verdicts}, the "
                         f"range payload with a Zv byte changed {bad_ok}")
    print(f"phase 16a: create_random_good_test_data against a cluster of "
          f"phase 7's configuration ({gen_s:.1f} s with the cluster and its "
          f"u={GEN_U} signatures): all five payloads accepted by the port's "
          f"verifier for their type {verdicts}; the range payload with one "
          f"Zv byte changed rejected; launches of the generation "
          f"{gen_launches}", flush=True)
    return total, walls


def simul_clear(cfg):
    """The clear answer of a runner row, from its own default_rng(seed)
    draws (simul/runner.py's data)."""
    rng = np.random.default_rng(cfg["seed"])
    datas = [rng.integers(cfg["query_min"], max(cfg["query_max"], 1),
                          size=(cfg["rows_per_dp"],))
             for _ in range(cfg["nbr_dps"])]
    if cfg["operation"] == "sum":
        return int(sum(int(d.sum()) for d in datas))
    if cfg["operation"] == "max":
        return int(max(int(d.max()) for d in datas))
    raise SystemExit(f"no clear answer for {cfg['operation']}")


def commit_slices(n_values, tile):
    """The value slices of a tiled creation's commit stage."""
    from drynx_tpu_torch.encoding import tiles
    from drynx_tpu_torch.parallel import proof_plane as plane

    return plane.shard_slices(n_values, tiles.proof_tile_shards(n_values,
                                                                tile))


def phase16b(zero_launches, launch_counts):
    """The simulation harness: run_file on the port's drynx.toml and
    minmax.toml (csv_out in a temporary directory), every row counted and
    held to its clear answer, the 10,000-bucket row's tiles; then one DP's
    10,000 values created tiled and monolithic from the same draws.
    Returns (launches, walls)."""
    import csv
    import os
    import tempfile

    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.encoding import tiles
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.service import service as svc
    from drynx_tpu_torch.simul import runner, timedata
    from drynx_tpu_torch.utils import cuda_build

    root = os.path.dirname(os.path.abspath(__file__))
    rows, total, walls = [], {}, []
    run_simulation = runner.run_simulation

    def counted(cfg, device=None):
        zero_launches()
        t0 = time.perf_counter()
        res = run_simulation(cfg, device)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        shapes = {k: dict(sorted(v.items()))
                  for k, v in sorted(cuda_build.LAUNCH_ROWS.items())}
        rows.append((res, launches, shapes, wall))
        return res

    runner.run_simulation = counted
    try:
        with tempfile.TemporaryDirectory(prefix="drynx_simul_") as tmp:
            for name in SIMUL_RUNFILES:
                path = os.path.join(root, "drynx_tpu_torch", "simul",
                                    "runfiles", name)
                csv_out = os.path.join(tmp, name[:-5] + ".timedata.csv")
                first = len(rows)
                results = runner.run_file(path, csv_out=csv_out)
                with open(csv_out) as f:
                    text = f.read()
                if text != runner.results_csv(results):
                    raise SystemExit(f"{name}: the CSV differs from its "
                                     f"results")
                table = list(csv.DictReader(text.splitlines()))
                if len(table) != len(results):
                    raise SystemExit(f"{name}: {len(table)} CSV rows")
                runs = [{k: float(v) for k, v in r.items()
                         if k not in ("operation", "servers", "dps", "vns")}
                        for r in table]
                print(f"phase 16b: {name}: {len(results)} rows; timedata "
                      f"(mean and best over the rows):\n"
                      + timedata.render(timedata.aggregate(runs)).rstrip(),
                      flush=True)
                for res, launches, shapes, wall in rows[first:]:
                    check_simul_row(res, launches, shapes, wall)
    finally:
        runner.run_simulation = run_simulation
    for res, launches, shapes, wall in rows:
        walls.append(wall)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # one DP's 10,000 values, tiled (tile=None: auto) and monolithic
    # (tile=0) from the same draws: byte-equal payloads, both peaks
    dev = torch.device("cuda")
    n = MINMAX_BIG
    gen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 16)
    sigs = svc.make_range_sigs(2, N_SERVERS, seed=SIG_SEED, device=dev)
    _, pub = eg.keygen(np.random.default_rng(PROOF_SEED + 16))
    tbl = eg.pub_table(pub).table.to(dev)
    bits = torch.randint(0, 2, (n,), generator=gen, device=dev)
    rs = eg.random_scalars((n,), gen, dev)
    cts = eg.encrypt_ints_with_tables(eg.BASE_TABLE.table.to(dev), tbl, bits,
                                      rs)
    draws = [eg.random_scalars(s, gen, dev)
             for s in ((n, 1), (n, 1), (n, 1), (N_SERVERS, n, 1))]
    blobs, peaks, g2_rows = {}, {}, {}
    for tile in (None, 0):
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pb = rp.create_range_proofs(bits, rs, cts, sigs, 2, 1, tbl,
                                    draws=draws, tile=tile)
        torch.cuda.synchronize()
        peaks[tile] = torch.cuda.max_memory_allocated() - base
        g2_rows[tile] = dict(cuda_build.LAUNCH_ROWS["g2_scalar_mul"])
        blobs[tile] = rp.RangeProofList(n, [(np.arange(n), pb)]).to_bytes()
    want_rows = collections.Counter(N_SERVERS * (b - a) for a, b in
                                    commit_slices(n, tiles.auto_tile(n)))
    if blobs[None] != blobs[0]:
        raise SystemExit("one DP's 10,000 values: the tiled payload differs "
                         "from the monolithic one")
    if g2_rows[None] != want_rows or g2_rows[0] != {N_SERVERS * n: 1}:
        raise SystemExit(f"one DP's 10,000 values: commit shapes "
                         f"{g2_rows}, want {dict(want_rows)} tiled")
    print(f"phase 16b: one DP's {n} values (u=2, l=1, {N_SERVERS} servers): "
          f"tiled (tile=None, {sum(want_rows.values())} commit dispatches, "
          f"G2 ladder rows {g2_rows[None]}) and monolithic (tile=0) "
          f"payloads byte-equal ({len(blobs[0])} bytes); peak device memory "
          f"above the inputs {peaks[None] / 2**30:.3f} GiB tiled, "
          f"{peaks[0] / 2**30:.3f} GiB monolithic", flush=True)
    return total, walls


def check_simul_row(res, launches, shapes, wall):
    """One runner row on the card: the clear answer, the responders, a
    clean block of the expected size, and above the tile threshold the
    tiled encryption and commit stage in their exact launch shapes."""
    from drynx_tpu_torch.encoding import tiles

    cfg = res["config"]
    want = simul_clear(cfg)
    what = (f"{cfg['operation']} {cfg['nbr_dps']} DPs x "
            f"{cfg['rows_per_dp']} rows over [{cfg['query_min']}, "
            f"{cfg['query_max']}], proofs {cfg['proofs']}")
    if res["result"] != want or not res["found"]:
        raise SystemExit(f"{what}: result {res['result']} (found "
                         f"{res['found']}), clear {want}")
    dps = [f"dp{i}" for i in range(cfg["nbr_dps"])]
    if res["responders"] != dps or res["absent"]:
        raise SystemExit(f"{what}: responders {res['responders']}")
    entries = (cfg["nbr_vns"] * (cfg["nbr_dps"] + 2 * cfg["nbr_servers"])
               if cfg["proofs"] else 0)
    if cfg["proofs"] and res["bitmap_codes"] != {1: entries}:
        raise SystemExit(f"{what}: bitmap codes {res['bitmap_codes']}, want "
                         f"{entries} entries of code 1")
    V = cfg["query_max"] - cfg["query_min"] + 1 if cfg["operation"] in (
        "max", "min") else 1
    tile = tiles.auto_tile(V)
    note = ""
    if tile:
        n_vals = cfg["nbr_dps"] * V
        plan = tiles.plan_tiles(V, tile)
        commit = collections.Counter(
            cfg["nbr_servers"] * cfg["ranges_l"] * (b - a)
            for a, b in commit_slices(n_vals, tiles.auto_tile(n_vals)))
        enc = collections.Counter(cfg["nbr_dps"] * (b - a)
                                  for a, b in plan.tiles)
        got_enc = {r: c for r, c in shapes.get("fixed_base_mul", {}).items()
                   if r in enc}
        # each encryption tile: r B, |m| B and r P
        if (shapes.get("g2_scalar_mul") != dict(commit)
                or got_enc != {r: 3 * c for r, c in enc.items()}):
            raise SystemExit(f"{what}: G2 ladder shapes "
                             f"{shapes.get('g2_scalar_mul')} (want "
                             f"{dict(commit)}), encryption shapes {got_enc} "
                             f"(want three launches a tile of {dict(enc)})")
        note = (f"; tiled: encryption in {plan.n_tiles} tiles "
                f"{[b - a for a, b in plan.tiles]}, the commit stage in "
                f"{sum(commit.values())} dispatches (G2 ladder rows "
                f"{dict(commit)})")
    t = res["timings"]
    print(f"phase 16b: {what}: result {res['result']} = the clear answer; "
          f"{len(dps)} responders; bitmap {res['bitmap_codes']}; "
          f"{wall:.3f} s (JustExecution {t['JustExecution']:.3f} s){note}; "
          f"launches {launches}", flush=True)
    if tile:
        print(f"phase 16b: launch shapes of that row, {{kernel: {{rows: "
              f"launches}}}}: {shapes}", flush=True)


def phase16c(ctx, zero_launches, launch_counts):
    """The proof plane and the collectives on a mesh of one card: phase 5's
    collection created over 4 shards, phase 6's payloads checked by the
    sharded verifier, the RLC totals, the dry-run step over 10 shards, the
    butterfly over 8, the scalar product and obfuscation over 3, and
    phase 9's DRO slabs' spans. ctx: phase 3's and 5's tensors (see main).
    Returns (launches, walls)."""
    from drynx_tpu_torch import dryrun
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.crypto import params as bn256
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.parallel import collective as col
    from drynx_tpu_torch.parallel import proof_mesh as pm
    from drynx_tpu_torch.parallel import proof_plane as plane
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.service import service as svc

    dev = torch.device("cuda")
    stats, enc_rs, ks_rs, setup = (ctx["stats"], ctx["enc_rs"],
                                   ctx["ks_rs"], ctx["setup"])
    sigs, payloads, coll_tbl = ctx["sigs"], ctx["payloads"], \
        setup.coll_pub_table
    pubs = [s.public for s in sigs]
    V = stats.shape[1]
    n_vals = NUM_DPS * V
    total, walls = {}, []

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    if plane.n_shards() != 1 or plane.enabled():
        raise SystemExit(f"the plane is on with one card: "
                         f"{plane.n_shards()} shards")

    # (1) phase 5's collection, its commit stage over 4 shards
    shifted = stats.to(torch.int64) + U ** L // 2
    cts = eg.encrypt_ints_with_tables(eg.BASE_TABLE.table.to(dev), coll_tbl,
                                      shifted, enc_rs).reshape(-1, 2, 3, 16)
    secrets = shifted.reshape(-1)
    rs = enc_rs.reshape(-1, 16)

    def draws():
        gen = torch.Generator(device=dev).manual_seed(PROOF_SEED)
        return [eg.random_scalars(s, gen, dev)
                for s in [(n_vals, L)] * 3 + [(N_SERVERS, n_vals, L)]]

    def create(**kw):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb = rp.create_range_proofs(secrets, rs, cts, sigs, U, L, coll_tbl,
                                    draws=draws(), **kw)
        torch.cuda.synchronize()
        return pb, launch_counts(), time.perf_counter() - t0

    mono, mono_l, mono_s = create()
    sharded, shard_l, shard_s = create(n_shards=SHARDS_16C)
    zero_launches()
    s_, t_, m_, v_ = draws()
    dig = torch.from_numpy(rp.to_base(secrets.cpu().numpy(), U, L)).to(
        dev, torch.int64)
    rp._commit_kernel(dig, s_, t_, m_, v_,
                      torch.stack([s.A for s in sigs]).to(dev), coll_tbl,
                      rp.sig_gt_pow_tables(sigs, dev), U, L)
    torch.cuda.synchronize()
    commit_l = launch_counts()
    add(shard_l)
    got = [rp.RangeProofList(V, [(np.arange(V), rp._slice_batch(
        sharded, np.arange(dp * V, (dp + 1) * V)))]).to_bytes()
        for dp in range(NUM_DPS)]
    want_l = {k: mono_l[k] + (SHARDS_16C - 1) * commit_l[k] for k in mono_l}
    if got != payloads:
        raise SystemExit("phase 5's collection over 4 shards: payloads differ")
    if shard_l != want_l:
        raise SystemExit(f"sharded creation launches {shard_l}, want "
                         f"{want_l} (one commit's {commit_l} x "
                         f"{SHARDS_16C})")
    walls.append(shard_s)
    print(f"phase 16c: phase 5's collection ({n_vals} values) with its "
          f"commit stage over {SHARDS_16C} shards on cuda:0: the ten "
          f"payloads byte-equal to phase 5's; {shard_s:.3f} s against "
          f"{mono_s:.3f} s on one; launches {shard_l} = one creation's + "
          f"{SHARDS_16C - 1} commits' ({commit_l})", flush=True)

    # (2) phase 6's payloads through the sharded verifier, then the RLC
    # totals under one weight draw
    fallbacks = rp.SHARDED_FALLBACKS
    ranges = [(U, L)] * V
    plane.set_shards(SHARDS_16C)
    try:
        zero_launches()
        t0 = time.perf_counter()
        ok = svc.verify_collected_range_proofs(payloads, ranges, {U: sigs},
                                               coll_tbl)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        add(launch_counts())
        verify_l = launch_counts()
        ok_bad = svc.verify_collected_range_proofs(
            ctx["bad"], ranges, {U: sigs}, coll_tbl)
    finally:
        plane.set_shards(None)
    if ok != [True] * NUM_DPS or ok_bad != [dp != TAMPER_DP
                                             for dp in range(NUM_DPS)]:
        raise SystemExit(f"sharded joint check: {ok}; with DP {TAMPER_DP}'s"
                         f" Zv changed {ok_bad}")
    if rp.SHARDED_FALLBACKS != fallbacks:
        raise SystemExit(f"{rp.SHARDED_FALLBACKS - fallbacks} sharded "
                         f"checks fell back to one device")
    walls.append(verify_s)
    pb = rp._concat_batches([rp.RangeProofList.from_bytes(b, dev)
                             .batches[0][1] for b in payloads])
    pre_ok, r_int, gtb_s = rp.rlc_prelude(
        pb, pubs, coll_tbl, rng=np.random.default_rng(PROOF_SEED))
    single = rp.rlc_total_single(pb, pubs, r_int, gtb_s)
    shards = pm.rlc_total_shards(pb, pubs, r_int, gtb_s,
                                 n_shards=SHARDS_16C)
    spmd = pm.rlc_total_sharded(col.make_mesh(SHARDS_16C), pb, pubs, r_int,
                                gtb_s)
    if not (pre_ok and torch.equal(shards, single)
            and torch.equal(spmd, single)
            and bool(F12.eq(single, F12.one((), dev)))):
        raise SystemExit("the sharded RLC totals differ from the "
                         "single-device one")
    print(f"phase 16c: phase 6's ten payloads through the sharded verifier "
          f"({SHARDS_16C} shards) {verify_s:.3f} s: {ok}; DP {TAMPER_DP}'s "
          f"tampered payload rejected alone {ok_bad}; fallbacks to one "
          f"device {rp.SHARDED_FALLBACKS - fallbacks}; launches {verify_l}; "
          f"under one weight draw rlc_total_shards and rlc_total_sharded "
          f"(the GT all-reduce over {SHARDS_16C} shards) byte-equal to "
          f"rlc_total_single, which is one", flush=True)

    # (3) the dry-run step at phase 3's width over 10 shards: the ring
    mesh = col.make_mesh(NUM_DPS)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, dec, found = dryrun.dryrun_step(setup, ctx["params"], stats, enc_rs,
                                       ks_rs, mesh=mesh)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry_l = launch_counts()
    add(dry_l)
    n = NUM_DPS
    rounds = n.bit_length() - 1 if n & (n - 1) == 0 else n - 1
    # per shard the flagship's kernels but its three reduces, then three
    # all-reduces (the ciphertexts, the key switch's K and C)
    want_dry = {**dict.fromkeys(dry_l, 0), "fixed_base_mul": 5 * n,
                "scalar_mul": 2 * n, "point_add": 4 * n + 3 * rounds * n,
                "fp_inv": n}
    w_err = float((w.cpu() - ctx["w3"].cpu()).abs().max())
    if (not bool(found.all()) or not torch.equal(dec.cpu(), ctx["dec3"].cpu())
            or w_err > 1e-3 * max(1.0, float(ctx["w3"].abs().max()))):
        raise SystemExit(f"dry-run step: sums or weights differ (weights "
                         f"{w_err})")
    if dry_l != want_dry:
        raise SystemExit(f"dry-run launches {dry_l}, want {want_dry}")
    walls.append(dry_s)
    print(f"phase 16c: the dry-run step over {n} shards on "
          f"{sorted({str(d) for d in mesh})} (the ring, {rounds} rounds): "
          f"{dry_s:.3f} s; the {V} decrypted sums equal phase 3's, weights "
          f"max abs err {w_err:.3g}; launches {dry_l}", flush=True)

    # (4) the butterfly over 8 shards of phase 3's ciphertexts
    cts3 = eg.encrypt_ints_with_tables(eg.BASE_TABLE.table.to(dev), coll_tbl,
                                       stats, enc_rs)
    xs = [cts3[i] for i in range(BUTTERFLY_SHARDS)]
    zero_launches()
    allr = col.allreduce_group_add(xs)
    torch.cuda.synchronize()
    bf_l = launch_counts()
    add(bf_l)
    seq = xs[0]
    for x in xs[1:]:
        seq = C.add(seq, x)
    k = BUTTERFLY_SHARDS

    def affine(t):
        x, y, z = C.normalize(t)
        return torch.stack([F.from_mont(x), F.from_mont(y)]), z

    (ga, gz), (wa, wz) = affine(torch.stack(allr)), affine(
        torch.stack([seq] * k))
    if not (torch.equal(ga, wa) and torch.equal(gz, wz)):
        raise SystemExit("the butterfly's totals differ from the "
                         "sequential sum")
    if bf_l["point_add"] != (k.bit_length() - 1) * k:
        raise SystemExit(f"butterfly launches {bf_l}")

    # (5) the scalar product over 3 shards and obfuscation
    gen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 5)
    ss = [eg.random_scalars((V,), gen, dev) for _ in range(N_SERVERS)]
    prods = col.allreduce_scalar_mul(ss)
    host = [int(np.prod([int(v) for v in col_ints], dtype=object) % bn256.N)
            for col_ints in zip(*[F.to_int(s.cpu()).tolist() for s in ss])]
    if any(F.to_int(p.cpu()).tolist() != host for p in prods):
        raise SystemExit("the all-reduced scalar product differs from the "
                         "host's")
    vals = torch.arange(V, device=dev, dtype=torch.int64) % 3
    q_cts = eg.encrypt_ints_with_tables(
        eg.BASE_TABLE.table.to(dev), setup.query_pub_table, vals,
        eg.random_scalars((V,), gen, dev))
    zero_launches()
    obf = col.obfuscate_collective([q_cts] * N_SERVERS, ss)
    add(launch_counts())
    qx = eg.secret_to_limbs(setup.query_secret).to(dev)
    zeros = [eg.decrypt_check_zero(o, qx).cpu() for o in obf]
    if any(not torch.equal(z, (vals == 0).cpu()) for z in zeros):
        raise SystemExit("obfuscation over 3 shards moved a zero")
    print(f"phase 16c: allreduce_group_add over {k} shards of phase 3's "
          f"ciphertexts (DPs 0-{k - 1}, the butterfly) equal to their "
          f"sequential sum after normalize, launches {bf_l}; "
          f"allreduce_scalar_mul over {N_SERVERS} shards equal to the host "
          f"product mod n; obfuscate_collective keeps {int((vals == 0).sum())}"
          f" zeros and {int((vals != 0).sum())} non-zeros", flush=True)

    # (6) phase 9's DRO slabs went through the plane's dispatch
    spans = sorted(k for k in plane.timers_snapshot()
                   if k.startswith("DRO") and ".shard" in k)
    if ctx.get("phase9") and not spans:
        raise SystemExit("phase 9's DRO slabs did not go through "
                         "dispatch_shards")
    print(f"phase 16c: the plane's shard spans of phase 9's DRO slabs: "
          f"{len(spans)} ({', '.join(spans[:6])}{', ...' if len(spans) > 6 else ''})",
          flush=True)
    return total, walls


class Scenarios16d:
    """The port's shell scenarios of SCENARIOS_16D as bash processes with
    every server on the card, started on entering (so their servers boot
    while phases 16a-c run) and awaited by `results`. The LR scenario's
    survey waits for `open_gate` (after 15a's timed surveys, which it
    would otherwise share the card with)."""

    def __enter__(self):
        import os
        import subprocess
        import tempfile

        root = os.path.dirname(os.path.abspath(__file__))
        self.tmp = tempfile.mkdtemp(prefix="scen16d-")
        self.gate = os.path.join(self.tmp, "go")
        env = dict(os.environ, PYTHON=sys.executable,
                   DRYNX_SCENARIO_GATE=self.gate)
        env.pop("DRYNX_SCENARIO_CPU", None)
        self.t0 = time.perf_counter()
        self.t_gate = None
        self.procs = {name: subprocess.Popen(
            ["bash", os.path.join(root, "drynx_tpu_torch", "scenarios",
                                  name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, start_new_session=True) for name in SCENARIOS_16D}
        # each scenario's output and the seconds to its end, by a waiter
        self.done = {}
        self.waiters = [threading.Thread(target=self._wait, args=(n,),
                                         daemon=True) for n in self.procs]
        for t in self.waiters:
            t.start()
        return self

    def _wait(self, name):
        stdout, stderr = self.procs[name].communicate(timeout=900)
        self.done[name] = (stdout, stderr, time.perf_counter() - self.t0)

    def open_gate(self):
        """Let the LR scenario's survey start."""
        open(self.gate, "w").close()
        self.t_gate = time.perf_counter() - self.t0

    def results(self):
        """{scenario: (stdout, seconds from the start to its end)}; raises
        SystemExit unless every one exited 0 and printed OK."""
        if self.t_gate is None:
            self.open_gate()
        out = {}
        for t in self.waiters:
            t.join()
        for name, p in self.procs.items():
            stdout, stderr, secs = self.done[name]
            out[name] = (stdout, secs)
            if p.returncode != 0 or "OK" not in stdout.split():
                raise SystemExit(f"{name} exited {p.returncode}:\n{stdout}"
                                 f"\n{stderr[-3000:]}")
        return out

    def __exit__(self, *exc):
        import os
        import signal

        import shutil

        for p in self.procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=60)
        shutil.rmtree(self.tmp, ignore_errors=True)
        return False


def phase16d(scen):
    """The scenarios' verdicts: each printed OK; the LR scenario's weights
    within 1e-9 of its clear-text twin with a clean bitmap."""
    out = scen.results()
    lr_out = out["client_run-lr-survey-proofs"][0]
    if ('"bitmap_ok": true' not in lr_out
            or "weights match clear-text twin" not in lr_out):
        raise SystemExit(f"LR scenario: {lr_out}")
    for name, (stdout, secs) in out.items():
        lines = [l for l in stdout.splitlines() if l.strip()]
        print(f"phase 16d: {name} (bash, servers on the card): OK, done "
              f"{secs:.1f} s after its start (with phase 16a; the LR "
              f"survey's gate opened at {scen.t_gate:.1f} s, after 15a); "
              f"{' | '.join(lines[-3:])[:400]}", flush=True)
    return out


def new_phases(stats, X, y, params, zero_launches, launch_counts,
               verify_range_alone=None, only=None, timers7="not measured",
               w7=None):
    """Phases 10-12, 14a and 14c (`only`: some of "10a", "10b", "11",
    "12", "14a", "14c", run in that order; 14c scores with the weights
    `w7`), 10-12 and 14c each keeping its kernels' largest calls; every
    kept call is then held against its plain version. Returns {phase:
    (launches, walls)}."""
    kept = KeptCalls(KeptCalls.G1 + KeptCalls.PAIRING)
    out, pima = {}, []

    def pima_cluster():
        # phases 10b, 11 and 14a share one cluster of phase 7's
        # configuration
        if not pima:
            t0 = time.perf_counter()
            pima.append(cluster_pima(X, y))
            print(f"phases 10b, 11 and 14a: cluster keys, tables and "
                  f"{N_SERVERS} signature sets of u={U} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        return pima[0]

    runs = {"10a": lambda: phase10a(zero_launches, launch_counts, kept),
            "10b": lambda: phase10b(pima_cluster(), stats, params,
                                    zero_launches, launch_counts, kept),
            "11": lambda: phase11(
                pima_cluster(), stats, params, zero_launches, launch_counts,
                kept, "not measured" if verify_range_alone is None
                else f"{verify_range_alone:.4f} s"),
            "12": lambda: phase12(zero_launches, launch_counts, kept),
            "14a": lambda: phase14a(pima_cluster(), stats, params,
                                    zero_launches, launch_counts, timers7),
            "14c": lambda: phase14c(X, params, w7, zero_launches,
                                    launch_counts,
                                    kept if shared_hold else None)}
    # 14c's kept calls join phases 10-12's hold when one of them runs (the
    # hold needs every kernel of the survey paths kept)
    shared_hold = bool(set(runs if only is None else only)
                       & {"10a", "10b", "11", "12"})
    for name in runs if only is None else only:
        t0 = time.perf_counter()
        out[name] = runs[name]()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s in all",
              flush=True)
    for c in pima:
        c.close()
    if not shared_hold:
        return out
    t0 = time.perf_counter()
    held = kept.hold()
    print(f"phases 10-12 and 14c: every kernel's largest call of each phase "
          f"byte-equal to its plain version "
          f"({time.perf_counter() - t0:.1f} s): {held}", flush=True)
    return out


def run_16abc(new, ctx, zero_launches, launch_counts, start, names):
    """Phases 16a, 16b and 16c (those of `names`), each timed; their
    (launches, walls) go into `new`."""
    runs = {"16a": lambda: phase16a(zero_launches, launch_counts,
                                    EXPECTED_LAUNCHES),
            "16b": lambda: phase16b(zero_launches, launch_counts),
            "16c": lambda: phase16c(ctx, zero_launches, launch_counts)}
    for name in names:
        print(f"-- phase {name} at {time.perf_counter() - start:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        new[name] = runs[name]()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s in all; "
              f"its launches {new[name][0]}", flush=True)


def phase17():
    """The runtime recorders' cross-checks on the card and the static
    analyzer (`drynx_tpu_torch.analysis.crosscheck`): 17a the lock-order
    child, 17b the same-seed bytes child twice, 17c the lifecycle child,
    each a fresh interpreter whose first import is drynx_tpu_torch, with
    its recorder armed, on cuda; 17d `python -m drynx_tpu_torch.analysis`
    over the tree that was shipped. All five processes run at once; each
    one's seconds are from the phase's start to its exit. Returns the
    children's launches, summed."""
    import os
    import tempfile

    from drynx_tpu_torch.analysis import crosscheck

    root = os.path.dirname(os.path.abspath(__file__))
    children = (("17a", "locks"), ("17b run 1", "bytes"),
                ("17b run 2", "bytes"), ("17c", "lifecycles"))
    procs, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="drynx_p17_") as d:
        files = {key: open(os.path.join(d, key), "w+")
                 for key, _ in children + (("17d", None),)}
        t0 = time.perf_counter()
        try:
            for key, which in children:
                procs[key] = crosscheck.spawn(which, "cuda",
                                              stdout=files[key])
            procs["17d"] = subprocess.Popen(
                [sys.executable, "-m", "drynx_tpu_torch.analysis"],
                cwd=root, stdout=files["17d"], stderr=subprocess.STDOUT)
            static = crosscheck.static_lock_edges()
            while len(secs) < len(procs):
                for key, proc in procs.items():
                    if key not in secs and proc.poll() is not None:
                        secs[key] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        texts = {}
        for key, f in files.items():
            f.seek(0)
            texts[key] = f.read()
            f.close()
    for key, proc in procs.items():
        if proc.returncode != 0:
            raise SystemExit(f"phase {key} exited {proc.returncode}:\n"
                             f"{texts[key][-4000:]}")
    out = {key: json.loads(texts[key].strip().splitlines()[-1])
           for key, _ in children}
    card = smi("name,power.limit")
    a = out["17a"]
    bad = crosscheck.check_locks(a, static)
    g1 = ("fixed_base_mul", "scalar_mul", "point_reduce", "fp_inv",
          "point_add")
    if any(a["launches"].get(k, 0) == 0 for k in g1):
        bad.append(f"the server drain's B1-B5 launches {a['launches']}")
    if bad:
        raise SystemExit(f"phase 17a: {bad}")
    print(f"phase 17a ({secs['17a']:.1f} s; {card}): a 2-worker server "
          f"drain of {crosscheck.LOCKS_BURST} sums, {a['shed']} shed, {a['completed']} "
          f"completed, {a['acquires']} traced acquisitions; observed "
          f"named-lock edges {a['edges']} within the static graph's "
          f"{sorted(static)}; launches {a['launches']}", flush=True)
    b1, b2 = out["17b run 1"], out["17b run 2"]
    bad = crosscheck.check_bytes(b1, b2)
    if bad:
        raise SystemExit(f"phase 17b: {bad}")
    snap = b1["snapshot"]
    print(f"phase 17b ({secs['17b run 1']:.1f} s and "
          f"{secs['17b run 2']:.1f} s; {card}): two same-seed proofs-on "
          f"sums, {snap['writes']} writes at {len(snap['records'])} keys "
          f"({len(snap['laundered'])} laundered), no divergence outside "
          f"{crosscheck.BYTES_EXEMPT}; launches equal, {b1['launches']}",
          flush=True)
    c = out["17c"]
    bad = crosscheck.check_lifecycles(c)
    if c["launches"].get("fixed_base_mul", 0) == 0:
        bad.append(f"the refills' launches {c['launches']}")
    if bad:
        raise SystemExit(f"phase 17c: {bad}")
    from drynx_tpu_torch.analysis import prototrace
    print(f"phase 17c ({secs['17c']:.1f} s; {card}): no violation; "
          f"coverage {prototrace.coverage(c['snapshot'])}; the refills' "
          f"launches {c['launches']}", flush=True)
    print(f"phase 17d ({secs['17d']:.1f} s): python -m "
          f"drynx_tpu_torch.analysis exit 0: "
          f"{texts['17d'].strip().splitlines()[-1]}", flush=True)
    launches = collections.Counter()
    for o in out.values():
        launches.update(o["launches"])
    return launches, [max(secs.values())]


def only_ctx(stats, enc_rs, ks_rs, setup, params, fn, need):
    """Phase 16c's inputs when phases 3-6 do not run: phase 3's survey,
    phase 5's signatures and payloads, phase 6's tampered copy."""
    from drynx_tpu_torch.service import service as svc

    ctx = dict(stats=stats, enc_rs=enc_rs, ks_rs=ks_rs, setup=setup,
               params=params, phase9=False)
    if not need:
        return ctx
    dev = torch.device("cuda")
    ctx["w3"], ctx["dec3"], _ = fn(stats, enc_rs, ks_rs)
    ctx["sigs"] = sigs = svc.make_range_sigs(U, N_SERVERS, seed=SIG_SEED,
                                             device=dev)
    _, lists = svc.collect_with_range_proofs(
        stats, enc_rs, [(U, L)] * stats.shape[1], {U: sigs},
        setup.coll_pub_table,
        generator=torch.Generator(device=dev).manual_seed(PROOF_SEED))
    ctx["payloads"] = [lst.to_bytes() for lst in lists]
    ctx["bad"] = list(ctx["payloads"])
    ctx["bad"][TAMPER_DP] = tamper_zv(ctx["payloads"][TAMPER_DP])
    return ctx


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    start = time.perf_counter()
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = sys.argv[2].split(",")
    from drynx_tpu_torch import flagship
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import elgamal as eg
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import fp2 as F2
    from drynx_tpu_torch.crypto import fp12 as F12
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import gt as GT
    from drynx_tpu_torch.crypto import params as bn256, refimpl
    from drynx_tpu_torch.models import logreg as lr
    from drynx_tpu_torch.proofs import encoding as enc
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.service import service as svc
    from drynx_tpu_torch.utils import cuda_build

    def zero_launches():
        for counts in (cuda_ops.LAUNCHES, cuda_pairing.LAUNCHES):
            for key in counts:
                counts[key] = 0
        cuda_build.reset_launch_rows()

    def launch_counts():
        return {**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES}

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"card: {card}; max SM clock {sm_mhz} MHz", flush=True)

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"phase 1: built {sorted(reports)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "stack frame", "spill")):
                print(f"  ptxas[{name}] {line.strip()}")

    # -- inputs at the main path's shapes ------------------------------------
    X, y, params = flagship.pima_shaped_problem(
        num_dps=NUM_DPS, n_records=N_RECORDS, d=D, max_iterations=ITERS)
    t0 = time.perf_counter()
    setup = flagship.SurveySetup.create(n_servers=N_SERVERS,
                                        dlog_limit=DLOG_LIMIT, device=dev)
    stats, enc_rs, ks_rs = flagship.make_inputs(X, y, params, NUM_DPS,
                                                N_SERVERS, device=dev)
    V = stats.shape[1]
    print(f"setup: V={V} ciphertexts per DP, host keygen + tables "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if only is not None:
        rest = [p for p in only if p not in ("13", "14b", "15a", "15b", "17")
                and not p.startswith("16")]
        if rest:
            # without phase 7, its weights' stand-in for 14c: GD on the CPU
            # from the clear sums
            w = lr.train(lr.unpack(stats.sum(0).cpu(), params), params)
            new_phases(stats, X, y, params, zero_launches, launch_counts,
                       only=rest, w7=w.numpy())
        if "13" in only:
            phase13(zero_launches, launch_counts)
        if "14b" in only:
            phase14b(zero_launches, launch_counts)
        with contextlib.ExitStack() as stack:
            # 15b's servers and 16d's scenarios boot while 16a-c and 15a
            # run; 16d's LR survey starts after 15a
            cli = (stack.enter_context(CliNodes()) if "15b" in only
                   else None)
            scen = (stack.enter_context(Scenarios16d()) if "16d" in only
                    else None)
            sub16 = [p for p in ("16a", "16b", "16c") if p in only]
            if sub16:
                run_16abc({}, only_ctx(
                    stats, enc_rs, ks_rs, setup, params,
                    fn=flagship.build_pipeline(setup, params),
                    need="16c" in sub16), zero_launches, launch_counts,
                    start, sub16)
            if "15a" in only:
                phase15a(stats, X, y, params, zero_launches, launch_counts)
            if scen is not None:
                scen.open_gate()
            if cli is not None:
                phase15b(cli)
            if scen is not None:
                phase16d(scen)
        if "17" in only:
            t0 = time.perf_counter()
            phase17()
            print(f"phase 17: {time.perf_counter() - t0:.1f} s in all",
                  flush=True)
        print(f"-- done at {time.perf_counter() - start:.1f} s", flush=True)
        return 0
    base = eg.BASE_TABLE.table.to(dev)
    mag, _ = eg.magnitude_limbs(stats.reshape(-1))
    cts = eg.encrypt_ints_with_tables(base, setup.coll_pub_table, stats,
                                      enc_rs)                # (10, V, 2, 3, 16)
    pts_v = cts[0, :, 0]                                     # (V, 3, 16)
    secrets = setup.server_secrets[:, None, :].expand(N_SERVERS, V, 16)
    qx = eg.secret_to_limbs(setup.query_secret).to(dev).expand(V, 16)
    pts_sv = pts_v[None].expand(N_SERVERS, V, 3, 16).reshape(-1, 3, 16)
    # adds: valid points, with lanes that hit P + P, P + (-P) and infinity
    a900 = cts[:, :, 0].reshape(-1, 3, 16)
    b900 = cts[:, :, 1].reshape(-1, 3, 16).clone()
    b900[0], b900[1] = a900[0], C.neg(a900[1:2])[0]
    b900[2] = C.infinity((), dev)
    zs = cts[0, :, 1, 2].contiguous()                        # (V, 16) nonzero Z
    # the key switch's sums over the servers: its callers hand the reduce
    # contiguous (R, N, 3, 16) tensors, as these are
    ks_k = cts[:N_SERVERS, :, 0].contiguous()
    ks_c = cts[:N_SERVERS, :, 1].contiguous()
    # B4 at the cluster survey's row counts: canonical residues from a seed
    inv_rng = np.random.default_rng(PROOF_SEED + 4)
    inv_x = F.from_int([int.from_bytes(inv_rng.bytes(40), "little") % bn256.P
                        for _ in range(max(CLUSTER_ROWS["fp_inv"]))]).to(dev)
    inv_edge = fp_inv_edge_inputs(F, bn256, dev)

    # proofs-on setup: the servers' digit signatures and their GT window
    # tables (host pairings, timed as setup), then the four proof kernels'
    # inputs at the shapes of phase 5, built from the same tables and digits
    t0 = time.perf_counter()
    sigs = svc.make_range_sigs(U, N_SERVERS, seed=SIG_SEED, device=dev)
    gtb_table = rp.gt_base_table().to(dev)
    print(f"setup: {N_SERVERS} signature sets of u={U}, their {N_SERVERS * U}"
          f" host pairings and GT window tables "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ranges = [(U, L)] * V
    n_vals = NUM_DPS * V
    n_proofs = N_SERVERS * n_vals * L
    digits = torch.from_numpy(rp.to_base(
        (stats + U ** L // 2).reshape(-1).cpu().numpy(), U, L)).to(dev)
    A_tab = torch.stack([sg.A for sg in sigs]).to(dev)
    kgen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 1)
    g2_p = A_tab[:, digits.long()].reshape(-1, 3, 2, 16)    # (13500, 3, 2, 16)
    g2_k = eg.random_scalars((n_proofs,), kgen, dev)
    g2_z = cuda_pairing.g2_scalar_mul_flat(g2_p, g2_k)[:, 2].contiguous()
    win = torch.arange(64, device=dev)
    base_idx = (torch.arange(N_SERVERS, device=dev)[:, None, None] * U
                + digits.long()[None]).reshape(-1)
    g_multi = rp.sig_gt_pow_tables(sigs, dev)[
        base_idx[:, None], win[None, :], cuda_pairing.window_digits(g2_k)]
    g_multi = g_multi.reshape(-1, 8, 6, 2, 16)             # (108000, 8, ...)
    g_multi2 = cuda_pairing.f12_mulreduce8_flat(g_multi).reshape(
        -1, 8, 6, 2, 16)
    t_k = eg.random_scalars((n_vals * L,), kgen, dev)
    g_gtb = gtb_table[win[None, :], cuda_pairing.window_digits(t_k)].reshape(
        -1, 8, 6, 2, 16)                                   # (36000, 8, ...)
    g_gtb2 = cuda_pairing.f12_mulreduce8_flat(g_gtb).reshape(-1, 8, 6, 2, 16)
    gt1 = cuda_pairing.f12_mulreduce8_flat(g_multi2)
    gt2 = cuda_pairing.f12_mulreduce8_flat(g_gtb2).expand(
        N_SERVERS, -1, 6, 2, 16).reshape(-1, 6, 2, 16).contiguous()

    # the five verification kernels' inputs, from the payloads of one
    # collection (phase 5's seed): the RLC check's weighted G1 arguments
    # and blinded signatures, affine, for the Miller loop; the GT
    # commitments a (GPhi12 members) and conj6(a) for the powers, the
    # squares and the slot maps; the Miller values for the inverse
    coll_tbl = setup.coll_pub_table
    _, lists0 = svc.collect_with_range_proofs(
        stats, enc_rs, ranges, {U: sigs}, coll_tbl,
        generator=torch.Generator(device=dev).manual_seed(PROOF_SEED))
    pubs = [sg.public for sg in sigs]
    vb = rp._concat_batches([lst.batches[0][1] for lst in lists0])
    r_w = eg.int_to_scalar(torch.from_numpy(
        np.random.default_rng(PROOF_SEED).integers(
            1, 1 << 62, size=(N_SERVERS, n_vals, L), dtype=np.int64)
    ).to(dev)).reshape(-1, 16)
    ml_px, ml_py, _ = C.normalize(C.scalar_mul_short(
        rp._g1_args(vb, pubs).reshape(-1, 3, 16), r_w, 64))
    ml_qx, ml_qy, _ = G2.normalize(vb.v_pts.reshape(-1, 3, 2, 16))
    ml_in = (ml_px, ml_py, ml_qx, ml_qy)
    gt_a = vb.a.reshape(-1, 6, 2, 16).contiguous()
    gt_ca = F12.conj6(gt_a).contiguous()
    t1_k = F.from_int(refimpl.P - refimpl.N).to(dev).expand(
        n_proofs, 16).contiguous()
    ml_out = cuda_pairing.miller_flat(*ml_in)
    f12_bytes = nbytes(gt_a)

    # the ladder's other main-path shapes: the D equation's c C2 (one row a
    # value), the VN's key-switch check (c U, zx K, c W, c Y), c y (a row a
    # value and server) and the RLC weighting of every digit proof's
    # c y - Zphi B by its 62-bit weight (16 windows)
    u_k = F.from_int(bn256.U).to(dev)[None]
    lgen = torch.Generator(device=dev).manual_seed(PROOF_SEED + 3)
    ladder_rows = [
        (64, a900.repeat(3, 1, 1)[:n], eg.random_scalars((n,), lgen, dev),
         what) for n, what in ((n_vals, "D equation c C2"),
                               (4 * N_SERVERS * V, "key-switch check"),
                               (N_SERVERS * n_vals, "c y"))] + [
        (16, rp._g1_args(vb, pubs).reshape(-1, 3, 16), r_w,
         "RLC weighting")]
    K = NUM_DPS * V
    # the main path's plain runs that phase 2's partly filled blocks (its
    # extra shapes) are held against: each such block is a prefix of the
    # main shape's rows, so its kernel call is compared with the first N
    # rows of the main shape's one plain run
    # the ladder's 64-window calls of phase 2 (the main shapes': the key
    # switch's x K, decryption, the D equation, the key-switch check, c y;
    # then the crafted scalars') are held against one plain run over their
    # rows, and its partly filled blocks against the D equation's rows
    ladder64 = shared_plain(cuda_ops.scalar_mul_plain, lambda: [
        (pts_sv, secrets.reshape(-1, 16)), (pts_v, qx)] + [
        (p, k) for w, p, k, _ in ladder_rows if w == 64] + [ladder_crafted],
        64)
    ladder_main = prefixes(ladder64(2))
    # the Fp inverse's cluster shapes are prefixes of one set of rows
    inv_main = prefixes(lambda: cuda_pairing.fp_inv_plain(inv_x))
    # the G2 ladder's, the windowed power's and the Fp12 power's main
    # shapes share one plain run with the crafted rows of the same
    # arguments (and the power by u at N = 1 with the 63-bit a^r)
    g2_shared = shared_plain(cuda_pairing.g2_scalar_mul_plain,
                             lambda: [(g2_p, g2_k), g2_crafted])
    g2_main = prefixes(g2_shared(0))
    wpow63 = shared_plain(cuda_pairing.f12_wpow_plain, lambda: [
        (gt_ca, r_w), (gt_a[:1], u_k), wpow_crafted], 63, True)
    # the crafted rows at bit counts no main shape has join a longer run:
    # at nb bits the power reads the low 3 ceil(nb / 3) bits of k, and the
    # longer chain over k masked to them begins with exact products of one
    # (canonical residues), so its rows are byte-equal (held on the CPU
    # with the plain versions, every crafted row, both squares)
    wpow128 = shared_plain(cuda_pairing.f12_wpow_plain, lambda: [
        (gt_a, t1_k), wpow_crafted] + [
        (wpow_crafted[0], low_bits(wpow_crafted[1], wpow_read(nb)))
        for nb in WPOW_FOLD_CYC], 128, True)
    wpow256 = shared_plain(cuda_pairing.f12_wpow_plain, lambda: [
        (wpow_crafted[0], low_bits(wpow_crafted[1], min(wpow_read(nb), 256)))
        for nb in WPOW_BITS], 256, False)
    # likewise the Fp12 power's crafted rows at 1 and 63 bits join the
    # 256-bit run (square-and-multiply-always: a zero bit multiplies by one)
    pow_shared = {nb: shared_plain(cuda_pairing.f12_pow_plain,
                                   lambda nb=nb: [(gt_a, g2_k),
                                                  pow_crafted[nb]] + (
                                       [(pow_crafted[b][0],
                                         low_bits(pow_crafted[b][1], b))
                                        for b in POW_FOLD] if nb == 256
                                       else []), nb)
                  for nb in (48, 256)}
    mul_main = prefixes(lambda: cuda_pairing.f12_mul_plain(gt1, gt2))
    mr8_main = prefixes(lambda: cuda_pairing.f12_mulreduce8_plain(g_multi))
    miller_main = prefixes(lambda: cuda_pairing.miller_plain(*ml_in))
    wpow_main = prefixes(wpow63(0))
    cases = {
        # kernel: list of (label, wrapper call, plain call, mont muls/elem,
        #                  elements, bytes moved)
        "fixed_base_mul": [
            (f"W=64 N={K} (rB)", lambda: cuda_ops.fixed_base_mul_flat(
                base, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, enc_rs.reshape(-1, 16)),
             mm_fixed_base(enc_rs.reshape(-1, 16), 64), K,
             nbytes(base, enc_rs) + K * 192),
            (f"W=16 N={K} (|m|B)", lambda: cuda_ops.fixed_base_mul_flat(
                base, mag, 16),
             lambda: cuda_ops.fixed_base_mul_plain(base, mag, 16),
             mm_fixed_base(mag, 16), K, nbytes(base[:16], mag) + K * 192),
            (f"W=64 N={K} (rP)", lambda: cuda_ops.fixed_base_mul_flat(
                setup.coll_pub_table, enc_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.coll_pub_table,
                                                   enc_rs.reshape(-1, 16)),
             mm_fixed_base(enc_rs.reshape(-1, 16), 64), K,
             nbytes(base, enc_rs) + K * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rB)",
             lambda: cuda_ops.fixed_base_mul_flat(base, ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(base, ks_rs.reshape(-1, 16)),
             mm_fixed_base(ks_rs.reshape(-1, 16), 64), N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
            (f"W=64 N={N_SERVERS * V} (key switch rQ)",
             lambda: cuda_ops.fixed_base_mul_flat(setup.query_pub_table,
                                                  ks_rs.reshape(-1, 16)),
             lambda: cuda_ops.fixed_base_mul_plain(setup.query_pub_table,
                                                   ks_rs.reshape(-1, 16)),
             mm_fixed_base(ks_rs.reshape(-1, 16), 64), N_SERVERS * V,
             nbytes(base, ks_rs) + N_SERVERS * V * 192),
        ],
        "scalar_mul": [
            (f"W=64 N={N_SERVERS * V} (key switch xK)",
             lambda: cuda_ops.scalar_mul_flat(pts_sv, secrets.reshape(-1, 16)),
             ladder64(0),
             mm_scalar_mul(secrets.reshape(-1, 16), 64), N_SERVERS * V,
             N_SERVERS * V * (192 + 64 + 192)),
            (f"W=64 N={V} (decrypt)",
             lambda: cuda_ops.scalar_mul_flat(pts_v, qx.contiguous()),
             ladder64(1),
             mm_scalar_mul(qx, 64), V, V * (192 + 64 + 192)),
        ] + [
            (f"W={w} N={len(k)} ({what})",
             (lambda p=p, k=k, w=w: cuda_ops.scalar_mul_flat(p, k, w)),
             ladder64(2 + i) if w == 64 else
             (lambda p=p, k=k, w=w: cuda_ops.scalar_mul_plain(p, k, w)),
             mm_scalar_mul(k, w), len(k), len(k) * (192 + 64 + 192))
            for i, (w, p, k, what) in enumerate(ladder_rows)
        ],
        "point_reduce": [
            (f"R={NUM_DPS} N={2 * V} (aggregate)",
             lambda: cuda_ops.point_reduce_flat(cts.reshape(NUM_DPS, -1, 3, 16)),
             lambda: cuda_ops.point_reduce_plain(cts.reshape(NUM_DPS, -1, 3, 16)),
             MM_G1_ADD * (NUM_DPS - 1), 2 * V, (NUM_DPS + 1) * 2 * V * 192),
            (f"R={N_SERVERS} N={V} (key switch K sum)",
             lambda: cuda_ops.point_reduce_flat(ks_k),
             lambda: cuda_ops.point_reduce_plain(ks_k),
             MM_G1_ADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
            (f"R={N_SERVERS} N={V} (key switch C sum)",
             lambda: cuda_ops.point_reduce_flat(ks_c),
             lambda: cuda_ops.point_reduce_plain(ks_c),
             MM_G1_ADD * (N_SERVERS - 1), V, (N_SERVERS + 1) * V * 192),
        ],
        "point_add": [
            (f"N={n} ({what})",
             (lambda n=n: cuda_ops.point_add_flat(a900[:n], b900[:n])),
             (lambda n=n: cuda_ops.point_add_plain(a900[:n], b900[:n])),
             MM_G1_ADD, n, 3 * n * 192)
            for n, what in ((K, "encrypt mB + rP"),
                            (N_SERVERS * V, "key switch rQ - xK"),
                            (V, "key switch finish"), (V, "decrypt C - xK"))
        ],
        # the survey's normalize, then the cluster survey's other shapes
        "fp_inv": [
            (f"N={V} (normalize)", lambda: cuda_pairing.fp_inv_flat(zs),
             lambda: cuda_pairing.fp_inv_plain(zs), MM_FP_INV, V, 2 * V * 64),
        ] + [
            (f"N={n} (cluster survey)",
             (lambda n=n: cuda_pairing.fp_inv_flat(inv_x[:n])),
             inv_main(n), MM_FP_INV,
             n, 2 * n * 64)
            for n in sorted(CLUSTER_ROWS["fp_inv"]) if n != V
        ],
        "f2_inv": [
            (f"N={n_proofs} (normalize V)",
             lambda: cuda_pairing.f2_inv_flat(g2_z),
             lambda: cuda_pairing.f2_inv_plain(g2_z), MM_F2_INV, n_proofs,
             2 * nbytes(g2_z)),
        ],
        "g2_scalar_mul": [
            (f"N={n_proofs} (V = v A[digit])",
             lambda: cuda_pairing.g2_scalar_mul_flat(g2_p, g2_k),
             g2_main(n_proofs), mm_g2_ladder(g2_k), n_proofs,
             2 * nbytes(g2_p) + nbytes(g2_k)),
        ],
        "f12_mul": [
            (f"N={n_proofs} (a = gt1 gt2)",
             lambda: cuda_pairing.f12_mul_flat(gt1, gt2),
             mul_main(n_proofs), MM_F12_MUL, n_proofs, 3 * nbytes(gt1)),
            ("N=1 (final exp, total)",
             lambda: cuda_pairing.f12_mul_flat(gt1[:1], gt2[:1]),
             lambda: cuda_pairing.f12_mul_plain(gt1[:1], gt2[:1]),
             MM_F12_MUL, 1, 3 * 768),
        ],
        "f12_mulreduce8": [
            (f"N={g.shape[0]} ({what})",
             (lambda g=g: cuda_pairing.f12_mulreduce8_flat(g)),
             mr8_main(len(g)) if g is g_multi else
             (lambda g=g: cuda_pairing.f12_mulreduce8_plain(g)),
             7 * MM_F12_MUL, g.shape[0], nbytes(g) * 9 // 8)
            for g, what in ((g_multi, "digit power, pass 1"),
                            (g_multi2, "digit power, pass 2"),
                            (g_gtb, "gtB^t, pass 1"),
                            (g_gtb2, "gtB^t, pass 2"))
        ],
        "miller": [
            (f"N={n_proofs} (RLC Miller loop)",
             lambda: cuda_pairing.miller_flat(*ml_in),
             miller_main(n_proofs), mm_miller(cuda_pairing.ATE_BITS), n_proofs,
             nbytes(*ml_in) + f12_bytes),
        ],
        # B8, B10, B11: the per-value check's final exponentiation at
        # 13,500 rows, the joint check's at N = 1
        "f12_inv": [
            (f"N={n} ({what} final exp)",
             (lambda n=n: cuda_pairing.f12_inv_flat(ml_out[:n])),
             (lambda n=n: cuda_pairing.f12_inv_plain(ml_out[:n])),
             MM_F12_INV, n, 2 * n * 768)
            for n, what in ((n_proofs, "per-value"), (1, "joint check"))
        ],
        "f12_csqr": [
            (f"N={n} ({what} final exp)",
             (lambda n=n: cuda_pairing.f12_csqr_flat(gt_a[:n])),
             (lambda n=n: cuda_pairing.f12_csqr_plain(gt_a[:n])),
             MM_F12_CSQR, n, 2 * n * 768)
            for n, what in ((n_proofs, "per-value"), (1, "joint check"))
        ],
        "f12_slotmul": [
            (f"N={n} ({w})",
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_flat(gt_a[:n], w)),
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_plain(gt_a[:n], w)),
             MM_F12_SLOTMUL, n, 2 * n * 768)
            for n in (n_proofs, 1) for w in cuda_pairing.SLOT_MAPS
        ],
        "f12_wpow": [
            (f"N={n_proofs} 128 bits cyc (order gate)",
             lambda: cuda_pairing.f12_wpow_flat(gt_a, t1_k, 128, cyc=True),
             wpow128(0),
             mm_wpow(128, True), n_proofs, 2 * f12_bytes + nbytes(t1_k)),
            (f"N={n_proofs} 63 bits cyc (a^r)",
             lambda: cuda_pairing.f12_wpow_flat(gt_ca, r_w, 63, cyc=True),
             wpow_main(n_proofs), mm_wpow(63, True), n_proofs,
             2 * f12_bytes + nbytes(r_w)),
            ("N=1 63 bits cyc (final exp, power by u)",
             lambda: cuda_pairing.f12_wpow_flat(gt_a[:1], u_k, 63, cyc=True),
             wpow63(1),
             mm_wpow(63, True), 1, 2 * 768 + 64),
        ],
        # square-and-multiply-always; the bound counts the squares and the
        # set bits' products that these exponents need (mm_pow)
        "f12_pow": [
            (f"N={n_proofs} {n} bits", (lambda n=n: cuda_pairing.f12_pow_flat(
                gt_a, g2_k, n)),
             pow_shared[n](0),
             mm_pow(g2_k, n) / n_proofs, n_proofs,
             2 * f12_bytes + nbytes(g2_k))
            for n in (48, 256)
        ],
    }
    # the team kernels and the slot map at more shapes than the main
    # path's and on crafted inputs (the 8-way product at the joint check's
    # small shapes, the add at the cluster survey's other shapes): checked
    # and timed like the rows above, not summed. The crafted sums repeat
    # one point or meet infinity, which compute in far fewer products than
    # adds of distinct points: their bound counts only bytes
    rng_x = np.random.default_rng(PROOF_SEED + 2)
    ladder_crafted = crafted_ladder_cases(C, F, refimpl, dev)
    g2_crafted = crafted_g2_ladder_cases(G2, F, refimpl, dev)
    wpow_crafted = crafted_wpow_cases(F, F12, bn256, refimpl, dev)
    reduce_crafted = [crafted_reduce_cases(C, bn256, refimpl, r, dev)
                      for r in REDUCE_RS]
    slot_crafted = crafted_slotmul_cases(bn256, dev)
    # B5's other cluster shapes: the survey's operands, repeated; its
    # crafted pairs, the reduce's R = 2 chains (every branch of the
    # complete add)
    a13500, b13500 = a900.repeat(15, 1, 1), b900.repeat(15, 1, 1)
    add_p, add_q = reduce_crafted[REDUCE_RS.index(2)]
    # B8's crafted rows, alone and tiled to the per-value check's 13,500
    inv_crafted = crafted_inv_cases(F12, refimpl, dev)
    inv_tiled = inv_crafted.repeat(n_proofs // len(inv_crafted) + 1, 1, 1,
                                   1)[:n_proofs].contiguous()
    # B14's and B10's crafted rows, and tiled to their 13,500-row launches
    f2_crafted = crafted_f2_inv_cases(F2, bn256, dev)
    f2_tiled = f2_crafted.repeat(n_proofs // len(f2_crafted) + 1, 1,
                                 1)[:n_proofs].contiguous()
    csqr_crafted = crafted_csqr_cases(F12, refimpl, dev)
    csqr_tiled = csqr_crafted.repeat(n_proofs // len(csqr_crafted) + 1, 1, 1,
                                     1)[:n_proofs].contiguous()
    # B15's crafted rows at each POW_BITS, and tiled to 13,500 rows
    tile = lambda t: t.repeat(n_proofs // len(t) + 1, *[1] * (t.dim() - 1))[
        :n_proofs].contiguous()
    pow_crafted = {nb: crafted_pow_cases(F, F12, refimpl, nb, dev)
                   for nb in POW_BITS}
    pow_tiled = {nb: tuple(tile(t) for t in fk)
                 for nb, fk in pow_crafted.items()}
    # one plain run of the crafted rows at each POW_BITS: the tiled launch
    # is held against it tiled (a row-wise kernel)
    pow_crafted_plain = {nb: pow_shared[nb](1) if nb in pow_shared else
                         pow_shared[256](2 + POW_FOLD.index(nb))
                         for nb in pow_crafted}

    def scalars(n, n_windows):
        lim = min(refimpl.N, 16 ** n_windows)
        return F.from_int([int.from_bytes(rng_x.bytes(32), "little") % lim
                           for _ in range(n)]).to(dev)

    # one plain run for the fixed-base ladder at each W (N = 900) and for
    # the Fp12 inverse's crafted rows (each row alone and tiled)
    fb_k = {w: scalars(900, w) for w in (1, 16, 17, 64)}
    fb_plain = {w: prefixes(lambda w=w: cuda_ops.fixed_base_mul_plain(
        base, fb_k[w], w)) for w in fb_k}
    inv_plain = prefixes(lambda: cuda_pairing.f12_inv_plain(inv_crafted))(
        len(inv_crafted))
    extra = {
        # the crafted chains (every branch of the complete add), a reduce
        # of one row, and a partly filled block
        "point_reduce": [
            (f"crafted R={len(t)} N={t.shape[1]}",
             (lambda t=t: cuda_ops.point_reduce_flat(t)),
             (lambda t=t: cuda_ops.point_reduce_plain(t)), 0, t.shape[1],
             (len(t) + 1) * t.shape[1] * 192)
            for t in reduce_crafted
        ] + [
            (f"R={r} N={n}",
             (lambda r=r, n=n: cuda_ops.point_reduce_flat(
                 a900[:r * n].reshape(r, n, 3, 16))),
             (lambda r=r, n=n: cuda_ops.point_reduce_plain(
                 a900[:r * n].reshape(r, n, 3, 16))),
             MM_G1_ADD * (r - 1), n, (r + 1) * n * 192)
            for r, n in ((1, V), (10, 13))
        ],
        "point_add": [
            (f"N={n} (cluster survey)",
             (lambda n=n: cuda_ops.point_add_flat(a13500[:n], b13500[:n])),
             (lambda n=n: cuda_ops.point_add_plain(a13500[:n], b13500[:n])),
             MM_G1_ADD, n, 3 * n * 192)
            for n in (810, 13_500)
        ] + [
            (f"crafted pairs N={len(add_p)}",
             lambda: cuda_ops.point_add_flat(add_p, add_q),
             lambda: cuda_ops.point_add_plain(add_p, add_q), 0, len(add_p),
             3 * len(add_p) * 192)
        ],
        # the crafted rows (0, 1, a Miller output, b = 0, a = 0), each alone
        # and tiled to 13,500 rows
        "f12_inv": [
            (f"crafted row {k} N=1",
             (lambda k=k: cuda_pairing.f12_inv_flat(inv_crafted[k:k + 1])),
             (lambda k=k: inv_plain()[k:k + 1]), MM_F12_INV, 1, 2 * 768)
            for k in range(len(inv_crafted))
        ] + [
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f12_inv_flat(inv_tiled),
             lambda: tile(inv_plain()), MM_F12_INV,
             n_proofs, 2 * nbytes(inv_tiled))
        ],
        # the crafted rows (0, 1, (a, 0), (0, b), -1 - i, limbs at p - 1,
        # seeded) in one launch and tiled to 13,500 rows
        "f2_inv": [
            (f"crafted N={len(f2_crafted)}",
             lambda: cuda_pairing.f2_inv_flat(f2_crafted),
             lambda: cuda_pairing.f2_inv_plain(f2_crafted), MM_F2_INV,
             len(f2_crafted), 2 * nbytes(f2_crafted)),
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f2_inv_flat(f2_tiled),
             lambda: cuda_pairing.f2_inv_plain(f2_tiled), MM_F2_INV,
             n_proofs, 2 * nbytes(f2_tiled)),
        ],
        # the crafted rows (0, 1, the unit slots, GPhi12, outside it), each
        # alone (one team) and tiled to 13,500 rows
        "f12_csqr": [
            (f"crafted row {k} N=1",
             (lambda k=k: cuda_pairing.f12_csqr_flat(csqr_crafted[k:k + 1])),
             (lambda k=k: cuda_pairing.f12_csqr_plain(
                 csqr_crafted[k:k + 1])),
             MM_F12_CSQR, 1, 2 * 768)
            for k in range(len(csqr_crafted))
        ] + [
            (f"crafted rows tiled N={n_proofs}",
             lambda: cuda_pairing.f12_csqr_flat(csqr_tiled),
             lambda: cuda_pairing.f12_csqr_plain(csqr_tiled), MM_F12_CSQR,
             n_proofs, 2 * nbytes(csqr_tiled))
        ],
        # the crafted rows (exponents 0, 1, all n_bits set, bits only above
        # n_bits; 1, the unit slots, GPhi12, outside it) in one launch and
        # tiled to 13,500 rows, at each POW_BITS
        "f12_pow": [
            (f"crafted{tiled} {nb} bits",
             (lambda fk=fk, nb=nb: cuda_pairing.f12_pow_flat(*fk, nb)),
             pow_plain, mm_pow(fk[1], nb) / len(fk[1]), len(fk[1]),
             2 * nbytes(fk[0]) + nbytes(fk[1]))
            for nb in POW_BITS
            for tiled, fk, pow_plain in (
                ("", pow_crafted[nb], pow_crafted_plain[nb]),
                (f" tiled N={n_proofs}", pow_tiled[nb],
                 lambda nb=nb: tile(pow_crafted_plain[nb]())))
        ],
        # the crafted rows (zero slots, limbs at p - 1, -1, mixed)
        "f12_slotmul": [
            (f"crafted N={n} ({w})",
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_flat(
                 slot_crafted[:n], w)),
             (lambda w=w, n=n: cuda_pairing.f12_slotmul_plain(
                 slot_crafted[:n], w)),
             MM_F12_SLOTMUL, n, 2 * n * 768)
            for n in SLOTMUL_NS for w in cuda_pairing.SLOT_MAPS
        ],
        # partly filled last blocks, whole blocks (128 rows) and the edge
        # inputs (0 among them)
        "fp_inv": [
            (f"N={n}", (lambda n=n: cuda_pairing.fp_inv_flat(inv_x[:n])),
             inv_main(n), MM_FP_INV,
             n, 2 * n * 64)
            for n in (1, 5, 21, 128, 129)
        ] + [
            ("edge inputs", lambda: cuda_pairing.fp_inv_flat(inv_edge),
             lambda: cuda_pairing.fp_inv_plain(inv_edge), MM_FP_INV,
             len(inv_edge), 2 * nbytes(inv_edge))
        ],
        "f12_mul": [
            (f"N={n} (a partly filled block)",
             (lambda n=n: cuda_pairing.f12_mul_flat(gt1[:n], gt2[:n])),
             mul_main(n), MM_F12_MUL, n, 3 * n * 768)
            for n in (5, 21)
        ],
        "fixed_base_mul": [
            (f"W={w} N={n}",
             (lambda n=n, w=w: cuda_ops.fixed_base_mul_flat(
                 base, fb_k[w][:n], w)),
             fb_plain[w](n), mm_fixed_base(fb_k[w][:n], w), n,
             nbytes(base[:w], fb_k[w][:n]) + n * 192)
            for w in (1, 16, 17, 64) for n in (1, 90, 270, 900)
        ] + [
            (f"crafted table {name}",
             (lambda t=t, k=k: cuda_ops.fixed_base_mul_flat(t, k)),
             (lambda t=t, k=k: cuda_ops.fixed_base_mul_plain(t, k)),
             0, len(k), nbytes(t, k) + len(k) * 192)
            for name, t, k in crafted_fixed_base_cases(C, F, refimpl, dev)
        ],
        "scalar_mul": [
            (f"crafted W={w}",
             (lambda w=w: cuda_ops.scalar_mul_flat(*ladder_crafted, w)),
             ladder64(5) if w == 64 else
             (lambda w=w: cuda_ops.scalar_mul_plain(*ladder_crafted, w)),
             mm_scalar_mul(ladder_crafted[1], w), len(ladder_crafted[1]),
             len(ladder_crafted[1]) * (192 + 64 + 192))
            for w in (1, 2, 16, 64)
        ] + [
            (f"W=64 N={n} (a partly filled block)",
             (lambda n=n: cuda_ops.scalar_mul_flat(
                 ladder_rows[0][1][:n], ladder_rows[0][2][:n])),
             ladder_main(n), mm_scalar_mul(ladder_rows[0][2][:n], 64), n,
             n * (192 + 64 + 192))
            for n in (1, 5, 21)
        ],
        "g2_scalar_mul": [
            ("crafted", lambda: cuda_pairing.g2_scalar_mul_flat(*g2_crafted),
             g2_shared(1),
             mm_g2_ladder(g2_crafted[1]), len(g2_crafted[1]),
             2 * nbytes(g2_crafted[0]) + nbytes(g2_crafted[1]))
        ] + [
            (f"N={n} (a partly filled block)",
             (lambda n=n: cuda_pairing.g2_scalar_mul_flat(g2_p[:n],
                                                          g2_k[:n])),
             g2_main(n), mm_g2_ladder(g2_k[:n]), n,
             2 * nbytes(g2_p[:n]) + nbytes(g2_k[:n]))
            for n in (1, 5, 21)
        ],
        "f12_wpow": [
            (f"crafted {nb} bits cyc={cyc}",
             (lambda nb=nb, cyc=cyc: cuda_pairing.f12_wpow_flat(
                 *wpow_crafted, nb, cyc=cyc)),
             wpow63(2) if (nb, cyc) == (63, True) else
             wpow128(1) if (nb, cyc) == (128, True) else
             wpow128(2 + WPOW_FOLD_CYC.index(nb)) if cyc and nb < 256 else
             wpow256(WPOW_BITS.index(nb)) if not cyc else
             (lambda nb=nb, cyc=cyc: cuda_pairing.f12_wpow_plain(
                 *wpow_crafted, nb, cyc)),
             mm_wpow(nb, cyc), len(wpow_crafted[0]),
             len(wpow_crafted[0]) * (2 * 768 + 64))
            for nb in WPOW_BITS for cyc in (True, False)
        ] + [
            (f"N={n} 63 bits cyc (a partly filled block)",
             (lambda n=n: cuda_pairing.f12_wpow_flat(gt_ca[:n], r_w[:n], 63,
                                                     cyc=True)),
             wpow_main(n), mm_wpow(63, True), n, n * (2 * 768 + 64))
            for n in (1, 5, 21)
        ],
        # the joint check's folds (five passes each over 13,500 values
        # padded to 8^5) and its gtB^S (two passes on one power), and
        # partly filled blocks (21, 5)
        "f12_mulreduce8": [
            (f"N={n} (joint check fold or gtB^S pass)",
             (lambda n=n: cuda_pairing.f12_mulreduce8_flat(g_multi[:n])),
             mr8_main(n), 7 * MM_F12_MUL, n, nbytes(g_multi[:n]) * 9 // 8)
            for n in (4096, 512, 64, 21, 8, 5, 1)
        ],
        "miller": [
            (f"N={n}",
             (lambda n=n: cuda_pairing.miller_flat(*(t[:n] for t in ml_in))),
             miller_main(n), mm_miller(cuda_pairing.ATE_BITS), n,
             nbytes(*(t[:n] for t in ml_in)) + n * 768)
            for n in (1, 1000)
        ],
    }
    meta = {
        "fixed_base_mul": ("drynx_tpu_torch/csrc/g1_ops.cu",
                           "drynx_tpu/crypto/pallas_ops.py:338"),
        "scalar_mul": ("drynx_tpu_torch/csrc/g1_ops.cu",
                       "drynx_tpu/crypto/pallas_ops.py:231"),
        "point_reduce": ("drynx_tpu_torch/csrc/g1_ops.cu",
                         "drynx_tpu/crypto/pallas_ops.py:437"),
        "point_add": ("drynx_tpu_torch/csrc/g1_ops.cu",
                      "drynx_tpu/crypto/pallas_ops.py:429"),
        "fp_inv": ("drynx_tpu_torch/csrc/fp_inv.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:949"),
        "f2_inv": ("drynx_tpu_torch/csrc/g2_ops.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:993"),
        "g2_scalar_mul": ("drynx_tpu_torch/csrc/g2_ops.cu",
                          "drynx_tpu/crypto/pallas_pairing.py:1114"),
        "f12_mul": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:529"),
        "f12_mulreduce8": ("drynx_tpu_torch/csrc/gt_ops.cu",
                           "drynx_tpu/crypto/pallas_pairing.py:629"),
        "miller": ("drynx_tpu_torch/csrc/miller.cu",
                   "drynx_tpu/crypto/pallas_pairing.py:313"),
        "f12_inv": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:535"),
        "f12_csqr": ("drynx_tpu_torch/csrc/gt_ops.cu",
                     "drynx_tpu/crypto/pallas_pairing.py:851"),
        "f12_slotmul": ("drynx_tpu_torch/csrc/gt_ops.cu",
                        "drynx_tpu/crypto/pallas_pairing.py:645"),
        "f12_wpow": ("drynx_tpu_torch/csrc/gt_ops.cu",
                     "drynx_tpu/crypto/pallas_pairing.py:572"),
        "f12_pow": ("drynx_tpu_torch/csrc/gt_ops.cu",
                    "drynx_tpu/crypto/pallas_pairing.py:541"),
    }

    # -- phase 2: every kernel against its plain version ---------------------
    print(f"-- phase 2 at {time.perf_counter() - start:.1f} s",
          flush=True)
    imad_per_ms = SMS * IMAD_PER_CLK_SM * sm_mhz * 1e3
    summary = {}
    print("phase 2: kernels vs plain versions (byte for byte)", flush=True)
    for name, rows in cases.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, err=0)
        source = meta[name][0].rsplit("/", 1)[1][:-3]
        symbol = f"{len(name) + 7}{name}_kernel"     # as mangled
        print(f"  {name}: ptxas {ptxas_summary(reports[source], symbol)}",
              flush=True)
        n_main = len(rows)
        for j, (label, kern, plain, mm, n, moved) in enumerate(
                rows + extra.get(name, [])):
            got = kern()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = int((got.long() - want.long()).abs().max())
            if got.shape != want.shape or err != 0:
                raise SystemExit(f"{name} {label}: kernel != plain version "
                                 f"(max abs err {err})")
            ms = cuda_ms(kern, KERNEL_REPS)
            ops_ms = mm * IMAD_PER_MONT_MUL * n / imad_per_ms
            bytes_ms = moved / MEM_BYTES_PER_S * 1e3
            print(f"  {name:15s} {label:32s} ok  kernel {ms:9.4f} ms  "
                  f"plain {plain_ms:10.2f} ms  bound {max(ops_ms, bytes_ms):.6f}"
                  f" ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})"
                  + ("" if j < n_main else "  (extra shape, not summed)"),
                  flush=True)
            if j >= n_main:
                continue
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
        summary[name] = tot

    # -- phase 3: the main path, counted --------------------------------------
    print(f"-- phase 3 at {time.perf_counter() - start:.1f} s",
          flush=True)
    fn = flagship.build_pipeline(setup, params)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, dec, found = fn(stats, enc_rs, ks_rs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"phase 3: first survey run {first_s:.3f} s; launches {launches}",
          flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise SystemExit(f"main-path launches {launches} differ from "
                         f"{EXPECTED_LAUNCHES}")

    clear = stats.sum(0).cpu()
    if dec.shape != (V,) or not torch.equal(dec.cpu().long(), clear):
        raise SystemExit("decrypted sums differ from the clear sums")
    if not bool(found.all()):
        raise SystemExit("a discrete-log lookup missed")
    # GD from the same sums on the CPU. Both run 450 float32 steps on sums
    # of up to ~1e4 (7680 records), taken in another order on the card, so
    # the weights part in the fourth digit: the tolerance is 1e-3 of the
    # largest weight
    w_cpu = lr.train(lr.unpack(dec.cpu(), params), params)
    w_err = float((w.cpu() - w_cpu).abs().max())
    w_tol = 1e-3 * max(1.0, float(w_cpu.abs().max()))
    if w.shape != (D + 1,) or not bool(torch.isfinite(w).all()) or w_err > w_tol:
        raise SystemExit(f"weights differ from CPU GD: max abs err {w_err}")
    print(f"  all {V} sums exact and found; weights {w.cpu().tolist()}; max abs"
          f" err vs CPU GD {w_err:.3g} (tolerance {w_tol:.3g})", flush=True)
    w3, dec3 = w, dec                   # phase 16c's dry run holds to them

    # -- phase 4: timings -------------------------------------------------------
    walls = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(stats, enc_rs, ks_rs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gd_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr.train(lr.unpack(dec, params), params)
        torch.cuda.synchronize()
        gd_s.append(time.perf_counter() - t0)
    print(f"phase 4: survey wall time median {statistics.median(walls):.4f} s "
          f"over {TIMED_RUNS} runs after warm-up (all: "
          f"{[round(x, 4) for x in walls]}); GD alone median "
          f"{statistics.median(gd_s):.4f} s", flush=True)

    # -- phase 5: proofs-on data collection, counted --------------------------
    print(f"-- phase 5 at {time.perf_counter() - start:.1f} s",
          flush=True)
    def collect():
        gen = torch.Generator(device=dev).manual_seed(PROOF_SEED)
        cts5, lists = svc.collect_with_range_proofs(
            stats, enc_rs, ranges, {U: sigs}, coll_tbl, generator=gen)
        return cts5, lists, [lst.to_bytes() for lst in lists]

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cts5, lists, payloads = collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches5 = launch_counts()
    print(f"phase 5: first proofs-on collection ({n_vals} values, {n_proofs} "
          f"digit proofs) {first_s:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches5}", flush=True)
    if launches5 != EXPECTED_LAUNCHES_PROOFS:
        raise SystemExit(f"proofs-on launches {launches5} differ from "
                         f"{EXPECTED_LAUNCHES_PROOFS}")

    # (a) D == c C2 + Zr P + (sum_j u^j Zphi_j) B for every value
    pbs = [lst.batches[0][1] for lst in lists]
    if len(lists) != NUM_DPS or any(
            len(lst.batches) != 1 or lst.batches[0][0].tolist() != list(range(V))
            for lst in lists):
        raise SystemExit("a payload does not cover its DP's values in one batch")
    cat = lambda name: torch.cat([getattr(pb, name) for pb in pbs])
    if not torch.equal(cat("commit"), cts5.reshape(-1, 2, 3, 16)):
        raise SystemExit("the proofs commit to other ciphertexts")
    wz = rp._weighted_sum_mod_n(cat("zphi"), rp._upow_mont(U, L, dev))
    d_want = C.add(C.scalar_mul(cat("commit")[:, 1], cat("challenge")),
                   C.add(eg.fixed_base_mul(coll_tbl, cat("zr")),
                         eg.fixed_base_mul(base, wz)))
    d_ok = C.eq(d_want, cat("d"))
    if d_ok.shape != (n_vals,) or not bool(d_ok.all()):
        raise SystemExit(f"D equation fails for {int((~d_ok).sum())} values")

    # (b) every challenge, recomputed from the serialized payload bytes
    wires = [parse_payload(p)[0] for p in payloads]
    sum_y = rp.sum_publics_bytes(sigs)
    for dp, w in enumerate(wires):
        if (w["u"], w["l"]) != (U, L) or w["idx"].tolist() != list(range(V)):
            raise SystemExit(f"DP {dp}: payload header differs")
        c_host = rp.challenge_from_wire(w, sum_y, U, L)
        if not np.array_equal(enc.limbs_to_bytes(c_host), w["challenge"]):
            raise SystemExit(f"DP {dp}: a challenge does not hash its "
                             f"transcript")

    # (c) the pairing equation of sampled digit proofs, by the host oracle,
    # and (d) a changed Zv fails it
    gtb = refimpl.pair(refimpl.G1, refimpl.G2)
    t0 = time.perf_counter()
    for dp, i, val, j in CHECK_SAMPLES:
        w = wires[dp]
        args = (big(w["challenge"][val]), sigs[i].public,
                big(w["zphi"][val, j]), big(w["zv"][i, val, j]),
                w["v"][i, val, j], w["a"][i, val, j])
        if not digit_pairing_ok(refimpl, gtb, *args):
            raise SystemExit(f"pairing equation fails at DP {dp} server {i}"
                             f" value {val} digit {j}")
    dp, i, val, j = CHECK_SAMPLES[-1]
    w = wires[dp]
    bad_zv = (big(w["zv"][i, val, j]) + 1) % refimpl.N
    if digit_pairing_ok(refimpl, gtb, big(w["challenge"][val]),
                        sigs[i].public, big(w["zphi"][val, j]), bad_zv,
                        w["v"][i, val, j], w["a"][i, val, j]):
        raise SystemExit("the pairing check accepts a tampered Zv")
    print(f"  (a) D equation holds for all {n_vals} values; (b) all "
          f"{n_vals} challenges recomputed from the payload bytes; (c) "
          f"pairing equation holds for {len(CHECK_SAMPLES)} sampled digit "
          f"proofs (DPs 0 and {NUM_DPS - 1}, all {N_SERVERS} servers, last "
          f"value and digit); (d) a tampered Zv fails it "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)

    # timings: whole collections, then the same work stage by stage (the
    # same generator seed, so the same bytes)
    def staged():
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        gen = torch.Generator(device=dev).manual_seed(PROOF_SEED)
        shifted = stats.to(torch.int64) + U ** L // 2
        cts_s = eg.encrypt_ints_with_tables(base, coll_tbl, shifted, enc_rs)
        mark()
        ctf = cts_s.reshape(-1, 2, 3, 16)
        dig = torch.from_numpy(rp.to_base(shifted.reshape(-1).cpu().numpy(),
                                          U, L)).to(dev, torch.int64)
        s_, t_, m_, v_ = [eg.random_scalars(shape, gen, dev) for shape in
                          [(n_vals, L)] * 3 + [(N_SERVERS, n_vals, L)]]
        d5, m_tot, v_pts, a5 = rp._commit_kernel(
            dig, s_, t_, m_, v_, A_tab, coll_tbl,
            rp.sig_gt_pow_tables(sigs, dev), U, L)
        mark()
        wire = rp._range_wire_dict(ctf, d5, v_pts, a5)
        c5 = rp.challenge_from_wire(wire, sum_y, U, L).to(dev)
        mark()
        zphi, zr, zv = rp._response_kernel(dig, c5, enc_rs.reshape(-1, 16),
                                           s_, t_, m_tot, v_)
        whole = rp.RangeProofBatch(ctf, c5, zr, d5, zphi, zv, v_pts, a5, U,
                                   L, wire)
        out = [rp.RangeProofList(V, [(np.arange(V), rp._slice_batch(
            whole, np.arange(dp * V, (dp + 1) * V)))]).to_bytes()
            for dp in range(NUM_DPS)]
        mark()
        if out != payloads:
            raise SystemExit("the staged run's payloads differ")
        return np.diff(marks)

    walls5 = []
    for _ in range(PROOF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, again = collect()
        torch.cuda.synchronize()
        walls5.append(time.perf_counter() - t0)
        if again != payloads:
            raise SystemExit("a warm collection's payloads differ")
    split = np.median([staged() for _ in range(PROOF_RUNS)], axis=0)
    print(f"phase 5: proofs-on collection wall time median "
          f"{statistics.median(walls5):.4f} s over {PROOF_RUNS} warm runs "
          f"(all: {[round(x, 4) for x in walls5]}); staged split, median of "
          f"{PROOF_RUNS}: encryption {split[0]:.4f} s, commit kernels "
          f"{split[1]:.4f} s, wire encoding + hash {split[2]:.4f} s, "
          f"response + payloads {split[3]:.4f} s", flush=True)

    # -- phase 6: the verifying node's joint check, counted ------------------
    print(f"-- phase 6 at {time.perf_counter() - start:.1f} s",
          flush=True)
    def verify(datas):
        return svc.verify_collected_range_proofs(datas, ranges, {U: sigs},
                                                 coll_tbl)

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok6 = verify(payloads)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches6 = launch_counts()
    print(f"phase 6: first joint check of the {NUM_DPS} payloads ({n_proofs} "
          f"digit proofs) {first_s:.3f} s; verdicts {ok6}; launches "
          f"{launches6}", flush=True)
    if ok6 != [True] * NUM_DPS:
        raise SystemExit(f"the joint check rejects honest payloads: {ok6}")
    if launches6 != EXPECTED_LAUNCHES_VERIFY:
        raise SystemExit(f"verification launches {launches6} differ from "
                         f"{EXPECTED_LAUNCHES_VERIFY}")

    bad = list(payloads)
    bad[TAMPER_DP] = tamper_zv(payloads[TAMPER_DP])
    ok_bad = verify(bad)
    if ok_bad != [dp != TAMPER_DP for dp in range(NUM_DPS)]:
        raise SystemExit(f"with DP {TAMPER_DP}'s Zv changed the joint check "
                         f"gives {ok_bad}")

    def decode(datas):
        return rp._concat_batches([rp.RangeProofList.from_bytes(b, dev)
                                   .batches[0][1] for b in datas])

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok_v = rp.verify_range_proofs(decode(payloads), pubs, coll_tbl)
    torch.cuda.synchronize()
    per_value_s = time.perf_counter() - t0
    launches_pv = launch_counts()
    if ok_v.shape != (n_vals,) or not ok_v.all():
        raise SystemExit(f"the per-value check rejects {int((~ok_v).sum())} "
                         f"honest values")
    if launches_pv != EXPECTED_LAUNCHES_PER_VALUE:
        raise SystemExit(f"per-value launches {launches_pv} differ from "
                         f"{EXPECTED_LAUNCHES_PER_VALUE}")
    ok_vb = rp.verify_range_proofs(decode(bad), pubs, coll_tbl)
    want_vb = np.arange(n_vals) != TAMPER_DP * V
    if not np.array_equal(ok_vb, want_vb):
        raise SystemExit("the per-value check of the tampered bytes rejects "
                         f"values {np.nonzero(~ok_vb)[0].tolist()}, not "
                         f"[{TAMPER_DP * V}]")
    print(f"  DP {TAMPER_DP} with one Zv byte changed: joint verdicts {ok_bad};"
          f" per-value check: all {n_vals} honest values accepted "
          f"({per_value_s:.3f} s, {n_proofs} pairings), on the tampered bytes"
          f" only value {TAMPER_DP * V} rejected; per-value launches "
          f"{launches_pv}", flush=True)

    def staged_verify():
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        pb = decode(payloads)
        mark()
        pre_ok, r_int, gtb_s = rp.rlc_prelude(pb, pubs, coll_tbl)
        mark()
        r = eg.int_to_scalar(torch.from_numpy(r_int).to(dev))
        px, py, _ = C.normalize(C.scalar_mul_short(rp._g1_args(pb, pubs), r,
                                                   64))
        qx, qy, _ = G2.normalize(pb.v_pts)
        mark()
        m = GT.miller(px, py, qx, qy)
        mark()
        ar = GT.gt_pow64(F12.conj6(pb.a), r)
        mark()
        fe = cuda_pairing.final_exp_flat(
            GT.gt_reduce_prod(m.reshape(-1, 6, 2, 16))[None])
        pa = GT.gt_reduce_prod(ar.reshape(-1, 6, 2, 16))
        total = GT.gt_mul(GT.gt_mul(fe, pa[None]), gtb_s[None])[0]
        mark()
        if not pre_ok or not bool(F12.eq(total, F12.one((), dev))):
            raise SystemExit("the staged joint check rejects")
        return np.diff(marks)

    walls6 = []
    for _ in range(PROOF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = verify(payloads)
        torch.cuda.synchronize()
        walls6.append(time.perf_counter() - t0)
        if again != [True] * NUM_DPS:
            raise SystemExit(f"a warm joint check gives {again}")
    split6 = np.median([staged_verify() for _ in range(PROOF_RUNS)], axis=0)
    print(f"phase 6: joint check wall time median "
          f"{statistics.median(walls6):.4f} s over {PROOF_RUNS} warm runs "
          f"(all: {[round(x, 4) for x in walls6]}); staged split, median of "
          f"{PROOF_RUNS}: decode {split6[0]:.4f} s, prelude (D equation, "
          f"challenges, GPhi12 and order gates, gtB^S) {split6[1]:.4f} s, G1 "
          f"weighting + normalize {split6[2]:.4f} s, Miller {split6[3]:.4f} s,"
          f" a^r {split6[4]:.4f} s, reductions + final exp {split6[5]:.4f} s;"
          f" peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # -- phase 7: the proofs-on LocalCluster survey, counted -----------------
    print(f"-- phase 7 at {time.perf_counter() - start:.1f} s",
          flush=True)
    launches7, walls7, verify_range7, res7 = phase7(
        stats, X, y, params, zero_launches, launch_counts)

    # -- phase 8: the obfuscated max survey, counted --------------------------
    print(f"-- phase 8 at {time.perf_counter() - start:.1f} s",
          flush=True)
    launches8, walls8 = phase8(zero_launches, launch_counts)

    # -- phase 9: the noised sum (DRO), counted -------------------------------
    print(f"-- phase 9 at {time.perf_counter() - start:.1f} s",
          flush=True)
    launches9, walls9 = phase9(zero_launches, launch_counts)

    # -- phases 10-12: grouped, cut, held and streaming surveys, counted ------
    print(f"-- phases 10-12, 14a and 14c at "
          f"{time.perf_counter() - start:.1f} s",
          flush=True)
    new = new_phases(stats, X, y, params, zero_launches, launch_counts,
                     verify_range7, timers7=phase_timers([res7]),
                     w7=res7.result)

    # -- phase 13: the standing server and its load, counted -----------------
    print(f"-- phase 13 at {time.perf_counter() - start:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    new["13"] = phase13(zero_launches, launch_counts)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s in all", flush=True)

    # -- phase 14b: a resumed survey through the server, counted ------------
    print(f"-- phase 14b at {time.perf_counter() - start:.1f} s", flush=True)
    t0 = time.perf_counter()
    new["14b"] = phase14b(zero_launches, launch_counts)
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s in all", flush=True)

    # 15b's servers and 16d's scenarios boot while phases 16a-c and 15a
    # run; 16d's LR survey starts after 15a's timed surveys
    with CliNodes() as cli, Scenarios16d() as scen:
        # -- phase 16a-c: datasets, the simulation harness, the proof plane -
        ctx = dict(stats=stats, enc_rs=enc_rs, ks_rs=ks_rs, setup=setup,
                   sigs=sigs, payloads=payloads, bad=bad, params=params,
                   w3=w3, dec3=dec3, phase9=True)
        run_16abc(new, ctx, zero_launches, launch_counts, start,
                  ("16a", "16b", "16c"))

        # -- phase 15: the survey over TCP, and the CLIs as processes --------
        print(f"-- phase 15a at {time.perf_counter() - start:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        new["15a"] = phase15a(stats, X, y, params, zero_launches,
                              launch_counts, res7, walls7[0])
        print(f"phase 15a: {time.perf_counter() - t0:.1f} s in all",
              flush=True)
        scen.open_gate()
        print(f"-- phase 15b at {time.perf_counter() - start:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        phase15b(cli)
        print(f"phase 15b: {time.perf_counter() - t0:.1f} s in all",
              flush=True)
        print(f"-- phase 16d at {time.perf_counter() - start:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        phase16d(scen)
        print(f"phase 16d: {time.perf_counter() - t0:.1f} s after 15b",
              flush=True)

    # -- phase 17: the recorders' cross-checks and the analyzer ------------------
    print(f"-- phase 17 at {time.perf_counter() - start:.1f} s", flush=True)
    t0 = time.perf_counter()
    new["17"] = phase17()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s in all", flush=True)

    kernels = []
    for name, tot in summary.items():
        source, replaces = meta[name]
        ops_ms, bytes_ms = tot["ops_ms"], tot["bytes_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches[name] + launches5[name] + launches6[name]
                         + launches_pv[name] + launches7[name]
                         + launches8[name] + launches9[name]
                         + sum(new[p][0][name] for p in new)),
            "max_abs_err": tot["err"], "ms": round(tot["ms"], 6),
            "plain_ms": round(tot["plain_ms"], 3),
            "bound_ms": round(max(ops_ms, bytes_ms), 6),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    print("(ms, plain_ms, bound_ms: summed over the kernel's main-path shapes "
          "above, one launch each; launches: the survey's, the proofs-on "
          "collection's, the joint check's, the per-value check's, the "
          "proofs-on cluster survey's, the obfuscated max survey's, the "
          "noised sum's, the grouped and the cut survey's, the held batch's, "
          "the stream's 1-pane advance's, phase 13's server surveys and "
          "load, the degraded survey's, the resumed survey's, the "
          "encrypted prediction's, the TCP survey's warm tree run, "
          "phase 16a-c's and phase 17's children's)")
    print(f"-- done at {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
