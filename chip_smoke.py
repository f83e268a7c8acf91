"""Smoke run of mrbayes_tpu_torch on one CUDA GPU.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py [--test1-gens N] [--primates-blocks N]
                          [--cynmix-gens N] [--switch-blocks N]
                          [--phases GROUP,...]

(defaults 1,000, 2, 300 and 1; primates blocks, cynmix generations and
switch blocks were 5, 2,000 and 3 before the sharded phases came and 3,
600 and 2 before the families phases, and test1's generations 20,000
before test2's came, 4,000 before the dating phases and 2,000 before the
analyses phases: each was cut to
keep the script within 600 s on a fast host and 700 s on a slow one,
and test1's 20,000-generation envelope is
checked by ``--test1-gens 20000``; test2 always runs the envelope's
20,000).  ``--phases`` runs only the named
groups after the device and build phases (``PHASE_GROUPS``: kernels 3,
17, 21; primates 4-5; test1 6-9; cynmix 10-12; sharded 13-16; clock
18-20; aa_codon 22-26; dating 27-31; kim_codon 32-37; covarion 38-41;
families 42-46; analyses 47-52; best 53-55; multiproc 56-58);
with a subset the
kernels line names every kernel with its numbers null, and the groups'
own lines carry what they measured.  Each
phase's end is logged with the seconds since the start.

Phases, each fatal on failure:
  1. device: the card's name, count, and name/power limit from nvidia-smi;
  2. build: compile every csrc/*.cu with nvcc for sm_90a (-Xptxas -v), one
     nvcc per source, all started together;
  3. kernels: the single-division pruning kernel, the multiwalk kernel, the
     wavefront kernel and the stacked kernel against their plain PyTorch
     versions on the card, at the test shapes, primates', test1's and
     cynmix's, and their times from CUDA-graph replays (a Python loop's
     beside): the multiwalk group beside pruning.cu once per division and
     the same group through stacked.cu, the wavefront beside pruning.cu
     on the same operands (and its root partials against pruning.cu's),
     the stacked kernel beside one launch per division and against each
     member's own launch, and on a group whose members take each walk;
     for every pruning.cu case, the multiwalk and wavefront kernels and
     the stacked kernel, the walk or plan chosen and the old
     global-scratch walk's time on the same operands (before_ms); the
     ptxas registers and spills of every kernel;
  4. primates: GTR+I+G Metropolis-coupled MCMC at 4 and 32 chains through
     the library entry points (Engine, init_chains, run_block): the
     pruning kernel's launches over the timed blocks, max lnL, carried
     versus recomputed scores, one block and one generation of each move
     type with host synchronisation made an error;
  5. golden gtr_ig: the tests/golden_primates.json rows on the card;
  6. test1: testing/test1.nex (two partitions, nst=mixed, invgamma,
     unlinked parameters, ratepr=variable, 2 runs x 4 chains) through
     cli.Interpreter.execute_file with the multiwalk switch on: the
     reference's envelope on the written files at 20,000 generations (a
     best lnL above -5800 below that), the multiwalk kernel's launches,
     carried versus recomputed scores, and the sump and sumt tables;
  7. switch: the same test1 engine with the multiwalk switch off and on,
     3 blocks of 200 generations each, in turns;
  8. sync: a block and one generation of each test1 move type with host
     synchronisation made an error;
  9. golden partitioned: the primates_part2_unlinked_gtr_g rows of
     tests/golden_extra.json through the port's CLI and engine;
 10. golden cynmix: the cynmix_mkv_f81 rows of tests/golden_primates.json
     with every kernel-path switch off, with the wavefront, stacked and
     multiwalk paths, and over 4 site shards of the card: each path's
     total within 0.25 of the reference, and each division's lnL within
     1e-3 of the other paths';
 11. cynmix: cynmix.nex's favored total-evidence model (Mk + four genes,
     8 divisions, 2 runs x 4 chains) through cli.Interpreter.execute_file
     with the wavefront and stacked switches on: carried versus recomputed
     scores, each pruner's launches against what the grouping predicts,
     the written files, sump and sumt;
 12. cynmix switch: gens/s with the switches off and on, in turns, and a
     block and one generation of each move type with host synchronisation
     made an error, switches on;
 13. sharded kernels: the pattern-sharded pruning launch
     (ops/sharded_cuda.py over pruning.cu) at primates' shape, C = 4 and
     32, over 1, 2 and 4 shards of the card, each shard against its plain
     version and its slice of one unsharded launch, with times;
 14. sharded primates: GTR+I+G, 4 chains, over 4 shards through Engine:
     lnL against the unsharded engine, gens/s of both in turns, one launch
     per shard and generation, carried versus recomputed scores, no host
     sync in any move type;
 15. sharded cynmix: the favored model over 4 shards: each division's lnL
     against the unsharded engine, launches (4 x 8 divisions plus 4 dummy
     passes per generation), carried versus recomputed, no host sync;
 16. the product path, parallel/dryrun.py's dryrun_sites over 4 shards;
     on a machine with several cards, the kernel check, primates and the
     dry run again over distinct cards;
 17. clock-tree kernels (run with phase 3): pruning.cu and multiwalk.cu
     against their plain versions on seeded random clock trees with
     IGR-spread branch lengths (about 1e-6 to tens of substitutions, the
     root at node 2n-2 with a zero-length branch) at test2's division
     shapes, C = 8 and 32, with each walk and its CUDA-graph time;
 18. golden clock: the clock_uniform_gtr_g rows of
     tests/golden_primates.json on the card (lnL within 0.2, lnPrior
     within 0.01 of the reference);
 19. test2: testing/test2.nex (test1's data and model on an IGR relaxed
     clock, brlenspr=clock:uniform clockratepr=exp(1), 2 runs x 4 chains,
     20,000 generations) through the CLI with the multiwalk switch on: the
     envelope, the multiwalk launches, carried versus recomputed scores,
     sump and sumt, complete .p/.t files with [&R] trees; then its engine
     with the switch off and on in turns (pruning.cu's launches with the
     switch off) and a block and one generation of every clock move type
     with host synchronisation made an error;
 20. prior-only: mcmc data=no on a uniform clock with IGR rates and
     clockratepr=exp(1), 32 runs x 1 chain, at two seeds: the mean root
     age, clock rate and branch rate each within 4 batch-means standard
     errors of 1, and statistics of the internal ages and the topology
     (the second-oldest and the mean internal age over the root age, the
     number of cherries, the smaller root clade) within 4 standard errors
     of a direct sample of the same prior (the moves' Hastings ratios);
 21. eigh kernel (run with phase 3): csrc/eigh.cu, the batched S > 8
     eigensolver, against its plain version (torch.linalg.eigh in float64)
     at [8, 20, 20], [32, 20, 20], [24, 61, 61] and [96, 61, 61] seeded
     reversible generators, Poisson's among them, and at runtime S 9, 60
     and 64 (B 8): reconstruction and P(t) at four branch lengths within
     1e-10 (a float32 solve misses it by three orders); against its kept
     first design (mb_eigh_jacobi_before) on the same batch: sweeps within
     one on every matrix and max |P(t) - first design's|; the sweeps
     taken, its CUDA-graph time and the first design's (before_ms),
     torch.linalg.eigh's (library_ms), the bound, each instantiation's
     thread split and shared memory (mb_eigh_plan, equal to
     ops/eigh_cuda.eigh_plan) and ptxas registers; pruning.cu at the avian
     (S 20, K 1 and 4) and replicase (S 61, K 1 and 3) shapes at C = 8 and
     32 runs with phase 3;
 22. golden protein and codon: the protein_jones_g and codon_m0 rows of
     tests/golden_primates.json and the replicase_ny98 rows of
     tests/golden_extra.json on the card (within 0.05, 0.6 and 1.0);
 23. avian: avian_ovomucoids.nex under the manual's aamodelpr=mixed
     through the CLI, 2 runs x 4 chains, 200 generations: one pruning.cu
     launch a likelihood, one eigh.cu launch at the engine's build (the 11
     models' fixed eigensystems as one batch) and none in the loop,
     carried versus recomputed scores, the files, sump
     and sumt, each model's posterior share;
 24. avian aamodelpr=fixed(gtr) and mixed: a block and one generation of
     every move type with host synchronisation made an error, eigh.cu
     once per Q move under gtr and never under mixed;
 25. replicase NY98: replicase.nex under lset nucmodel=codon omegavar=ny98
     through the CLI, 2 runs x 4 chains, 600 generations, with phase 23's
     checks and eigh.cu once per refresh; then the sync check of phase 24;
 26. prior-only protein and codon: mcmc data=no from draws of the prior,
     32 runs x 1 chain, 1,200 generations: each amino-acid model's share,
     M0's omega/(1+omega), NY98's omega1, omega3 and class frequencies
     within 4 batch-means standard errors of their prior means;
 27. hymfossil kernels (run with phase 3): pruning.cu against its plain
     version at every division shape of hymfossil.nex's FBD analysis (114
     tips; P with the coding dummies; S 2-7 and 4; K 4) at C = 8 and 32,
     on the engine's operands for the reference's dated trees (the
     hymfossil_fbd_totev rows' trees and ages: extant tips aged about
     1e-8, sampled ancestors on zero-length branches) with seeded
     substitution parameters: the walk taken, ms, before_ms, plain_ms and
     the bound of each;
 28. golden hymfossil: the hymfossil_fbd_totev rows of
     tests/golden_extra.json through the port's CLI and engine with every
     kernel-path switch off and with the multiwalk, wavefront and stacked
     paths: each path's total within the row's tol (3.0) of the
     reference, each division's lnL within 1e-3 of the other paths';
 29. hymfossil: the FBD analysis through the CLI (45 fossils with fixed
     ages, 15 divisions, 2 runs x 4 chains, 300 generations), switches
     off: one pruning.cu launch a division and likelihood, carried versus
     recomputed scores, every fixed fossil age held, the pinned ages
     ordered and no constraint broken, every sampled ancestor's parent at
     its fossil's age bit for bit on every chain of every sample, the
     .p/.t/.mcmc files with each sample's nSampledAncestors equal to its
     tree's zero-length tip branches, sump and sumt; each run's mean
     nSampledAncestors and the gens/s beside 34.9 before sampled
     ancestors were accepted (no gate on the count);
 30. dating sync: a block and one generation of every move type with host
     synchronisation made an error, on the hymfossil engine (add_branch,
     del_branch, the fossilization slider) and on small problems with a
     uniformly dated tip, a calibrated hard constraint, the CPP clock and
     clockvarpr=mixed (tip_date_slider, the CPP moves, rcl_jump);
 31. prior-only dating: mcmc data=no on an 8-tip FBD problem with 3 dated
     fossils and on a CPP problem, 32 runs x 1 chain, 1,000 generations on
     the card and on the port's own CPU engine (held against JAX in
     tests/test_torch_dating.py): the mean root age, sampled ancestors and
     CPP events within 4 batch-means standard errors of each other, and
     sampled ancestors on both sides; then the three-tip FBD problem of
     tests/fbd_small_trees.py (two extant tips and a fossil, 512 runs x 1
     chain drawing its own move, 600 generations of which the last 400
     are read) against the float64 integral of ln_fbd over its state
     space: the sampled-ancestor share (> 0), the mean root age and the
     share of ((A,B),F) within 4 batch-means standard errors;
 32. doublet and M3/M10 kernels: pruning.cu against its plain version at
     kim's stem doublets (27 tips, 78 pair patterns, S 16, K 1 and 4), its
     proteins (P 68 and 32, S 20), replicase under M3 (K 3, staged) and
     M10 (K 8, the tiled walk), and codon data on 114 taxa under M3 and
     M10 (the tiled walk), C = 8 and 32: the walk and block chosen (held
     to the size rule's Python twin), ms, before_ms (the old global
     walk) and the largest difference to it, plain_ms and the bound, and
     at the tiled shapes the tiled walk's other designs (cluster size 1,
     other tiles);
 33. eigh.cu at [8|32, 16, 16] (the doublet's runtime S) and [64|256, 61,
     61] (M10's eight classes a chain) with phase 21's gates and times;
 34. golden kim and M10: the kim_hky_g_mixed4, kim_stems_doublet_gtr,
     kim_protein_gtr and replicase_m10 rows within their tol, M10's class
     omegas within rtol 0.02 of the reference's;
 35. kim stem doublets: kim.nex under the kim_stems_doublet_gtr rows'
     model through the CLI (9 divisions, 2 runs x 4 chains, 300
     generations): exactly 9 pruning.cu launches a generation, eigh.cu
     once at the build per protein and once per doublet Q move, carried
     versus recomputed scores, the files, sump and sumt, gens/s; then the
     sync check of every move type with its eigh.cu prediction;
 36. replicase M10 (400 generations, on the tiled walk) and M3 (150)
     through the CLI with phase 35's checks and sync checks;
 37. kim's unlinked trees (set partition=by_gene; unlink topology=(all)
     brlens=(all)): 6 trees over 8 divisions (div_tree [0, 1, 2, 3, 4, 5,
     5, 5]), exactly 8 pruning.cu launches a generation, six .t files a
     run and six consensus trees, each division's lnL on its own tree
     through pruning.cu against the plain version within 1e-3 and the
     carried total against their sum, and the sync check;
 38. covarion and restriction kernels: pruning.cu against its plain
     version on the operands of this slice's engines (real covarion
     generators, whose switch blocks no category rate scales; restriction
     with its coding dummies and root frequencies): avian under Jones+G
     with covarion (89 tips, 88 patterns, S 40, K 4: the runtime-S staged
     walk), primates under HKY+G with covarion (12, 413, S 8, K 4: the
     whole walk) and the restriction matrix under directional root
     frequencies (6 tips, S 2, K 1 and 4), C = 8 and 32: the walk and block
     (held to the size rule's twin), ms, before_ms, plain_ms and the
     bound; eigh.cu at [32|128, 40, 40] on avian covarion's symmetrised
     generators with phase 21's gates and times;
 39. golden covarion and restriction: the primates_covarion_hky,
     restriction_directional and restriction_mixedfreq rows of
     tests/golden_extra.json within their tol (1.0, 0.3, 0.3);
 40. primates (2 runs) and avian (1 run) under the covarion model, and the
     restriction matrix under directional and mixed root frequencies (1
     run each), 4 chains, through the CLI: exactly one pruning.cu launch a
     generation, eigh.cu once per refresh of avian's 40-state
     eigensystems (the start and every shape or switch-rate move),
     carried versus recomputed scores (from fresh eigensystems), the files
     (rooted [&R] trees under directional root frequencies, the switch
     rates', rootpi and statefrmod columns), sump and sumt, gens/s;
 41. the sync check of every move type of avian covarion and of the
     restriction mixed model (rooted NNI and SPR, the root-frequency moves
     and the stationary/directional jump), with eigh.cu's launches.

 42. the families' kernel: pruning.cu against its plain version on the
     operands of cynmix's morphology under symdirihyperpr (the binary
     bucket: 32 tips, 124 patterns with the coding dummies, S 2, its 5
     beta x 4 gamma categories K 20, each category weighted at the root by
     its own frequencies; the 3-, 4- and 8-state buckets with sampled
     frequencies, K 4), C = 8 and 32: the walk and block (held to the
     whole walk and the size rule's twin), ms, before_ms, plain_ms and the
     bound;
 43. identical states: primates under adgamma, its codon positions under
     lnorm and kmixture, cynmix with symdirihyperpr or the parsimony model
     on its morphology and 32 simulated continuous taxa (50 traits), each
     engine on the card and on the CPU (the plain versions) at one state:
     each of the family's divisions' lnL per chain within 2e-3, every
     other division's within 2e-3 + 1.3e-6 |lnL|, and lnPrior within
     1e-4; adgamma against a float64 sequential forward over the
     card's own root partials (and its HMM's kernel launches counted:
     O(log sites)), continuous against the dense multivariate-normal REML
     oracle, the parsimony model against a numpy Fitch count, each within
     2e-3;
 44. the lnorm + kmixture divisions in one multiwalk.cu launch, each
     division's per-pattern lnL within 2e-5 of its own pruning.cu launch;
 45. the five through the CLI, 150 generations, 4 chains (primates
     adgamma 2 runs, multiwalk on for lnorm + kmixture): each division's
     kernel launched once a likelihood (none for a parsimony-model or
     continuous division), carried versus recomputed scores, finite .p
     files with the corr, mixturerates and brownScale columns, .t files,
     sump and sumt, gens/s;
 46. a block and one generation of every move type of each of the five
     with host synchronisation made an error;
 47. report, primates GTR+I+G with the apes constraint, 2 runs x 4 chains
     through the CLI (``report ancstates=yes siterates=yes``): the card's
     Reporter at the golden rows of tests/golden_ancstates.json within
     1e-3 max and 2e-4 mean of the reference, site rates within 0.02 of a
     float64 oracle, every p(.){c@apes} row of the .p files summing to 1
     within 1e-4, one host sync a sample, the report pass's kernels and ms;
 48. report, replicase under NY98 (``possel=yes siteomega=yes``), 1 run x
     4 chains: card against CPU at the run's final state within 1e-4,
     each pr+ in [0, 1], each omega within the class omegas;
 49. ss on primates GTR+I+G (1 x 4, 5 steps) then sumss: every step in
     the .ss file, its contributions equal to those recomputed from the
     sampled lnL within 1e-6, lnZ finite and below the highest lnL; a
     power-0 block (1 x 4 at temp 0, exponential(10) branch lengths): the
     mean tree length within 4 batch-means standard errors of 2.1;
 50. cynmix with starttree=parsimony, then starttree=nj nperts=2 (1 x 4):
     the run's gen-0 tree equal to the CPU port's from the same seed,
     carried = recomputed;
 51. tests/test_commands.py's SCRIPT (propset, startvals, plot,
     comparetree), compareref, outgroup, sump plot=yes, every
     informational command, delete 2 with an mcmc on the 11 taxa left and
     restore: each runs, each run's files complete;
 52. per-chain moves, primates 1 x 32: the move counts against the move
     probabilities (chi-square p > 1e-3), one pruning.cu launch a
     generation, carried = recomputed, no host sync in a block, and ms per
     generation with and without per-chain moves.
 53. BEST's gene stack: stacked.cu with a tree a member (the JAX engine's
     vmapped gene pass) at finch's 30 gene shapes (4 tips, S 4, K 1, 5-30
     patterns, 477 in all) at C = 8 and 32 and at a two-gene primates
     shape (12 tips, 6 species), on the engine's own operands: every
     gene's per-pattern lnL within 2e-5 of the plain version and of one
     pruning.cu launch a gene on the same operands; the CUDA-graph time
     beside those G launches', the plain version's, the bound and the
     plan;
 54. finch.nex's BEST model through the CLI (2 runs x 4 chains, 300
     generations): exactly one stacked.cu launch a likelihood and no
     pruning.cu launch, carried versus recomputed scores, the card against
     the port's CPU engine at the final state (each gene within 2e-3 +
     1.3e-6 |lnL|), the species .t files with the 4 species and the 30
     gene-tree files a run, sump and sumt, gens/s and CUDA kernels a
     generation;
 55. a block and one generation of every BEST move type with host
     synchronisation made an error.
 56. multiproc, the library: primates GTR+I+G on two ranks of
     torch.distributed sharing the card (gloo, the backend the rule
     gives; no MPS daemon), in two layouts, 2 timed blocks of 100
     generations each through Engine, init_chains, shard_chains and
     run_block, each block followed by the runner's one gather: (a) 2
     runs x 4 chains, a run a rank, and (b) 1 run x 8 chains, 4 a rank,
     E gathered every swap generation.  Each rank's pruning.cu launches
     one a generation; the gathered starting lnL equal to a one-process
     engine's on the card within 2e-5 |lnL|; carried versus recomputed on
     every chain of each rank; temp_id and the swap matrices the same on
     both ranks after every block, each run's temp_id a permutation; (a)
     no collective in a block, a block with host synchronisation an
     error, (b) one
     collective a swap generation; each rank's gens/s beside one
     process's on the same configuration.  The ranks are this script run as
     ``--worker`` subprocesses, started once for phases 56 and 57 after
     the build, under a timeout that kills every one on overrun;
 57. multiproc, the CLI: tests/test_multihost.py's DRIVE script (2 runs
     x 2 chains, nst 2 + gamma, 480 generations) through the CLI's main
     with --coordinator, --nprocs 2 and --procid on each rank, rank 1 in
     a directory of its own: rank 0 writes the .p, .t, .ckp, .mcmc,
     .con.tre, .pstat and .trprobs files and runs sump and sumt, rank 1
     writes nothing and prints no consensus, each rank's pruning.cu
     launches one a generation plus the start, the gens/s of both ranks
     beside the same script's in one process;
 58. the ranks' pruning.cu launches (each rank's counts in its JSON
     record, read and summed here) in the kernels line, beside the
     group's own line.

It prints one JSON line describing the kernels, then the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "tests", "data", "ref", "examples")
PRIMATES = os.path.join(EXAMPLES, "primates.nex")
GOLDEN = os.path.join(HERE, "tests", "golden_primates.json")
GOLDEN_EXTRA = os.path.join(HERE, "tests", "golden_extra.json")
OUT = os.path.join(HERE, "runs")           # run outputs (gitignored)
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
H100_FP64_FLOPS = 67e12          # fp64 on the tensor cores (data sheet)
RTOL = ATOL = 2e-5               # per-pattern lnL, kernel vs plain version
# wavefront cases (n_tips, P, S, K, W): every cynmix division (P with the
# coding dummies: the four genes, then the morphology buckets S = 2, 3, 8;
# S = 4's 10 patterns are covered by its neighbours) and
# tests/test_pallas.py's; each at C = 8 and 32 on random, caterpillar and
# balanced trees
CYNMIX_SHAPES = [(32, 537, 4, 4, 8), (32, 125, 4, 4, 8), (32, 203, 4, 4, 8),
                 (32, 330, 4, 4, 8), (32, 124, 2, 4, 8), (32, 34, 3, 4, 8),
                 (32, 9, 8, 4, 8)]
# multiwalk groups (n_tips, P_d, K_d, S, C): test1 at 8 and 32 chains, a
# group mixing K = 1 and K = 4, three divisions, and the S = 20 and
# runtime-S paths.  One group shares one S (the engine groups by S).
TEST1_SHAPE = (12, (199, 258), (4, 4), 4)
# pruning.cu cases (n_tips, P, S, K, C): those of tests/test_pallas.py and
# tests/test_torch_pruning.py, the S = 2 and runtime-S paths, primates,
# every cynmix division at 2 runs x 4 chains (the S 4 bucket's 10
# patterns included) and test1's two divisions at 8 chains (each the shape
# of a launch with the kernel-path switches off), and S = 20 at 32 tips.
# The size rule (csrc/onchip_walk.cuh) gives S = 20 and (6, 40, 61, 3)
# their operators staged a step ahead and (9, 70, 32, 16) the tiled walk
# (csrc/tiled_walk.cuh; the global-scratch walk before it); every other
# case the whole on-chip walk.
KERNEL_CASES = [(8, 137, 4, 4, C) for C in (1, 4, 8)] \
    + [(12, 434, 4, 1, C) for C in (1, 4, 8)] \
    + [(6, 40, 20, 2, C) for C in (1, 4, 8)] \
    + [(24, 64, 2, 4, 4), (6, 40, 61, 3, 4), (9, 70, 32, 16, 2)] \
    + [(12, 413, 4, 4, C) for C in (4, 32)] \
    + [(32, 34, 3, 4, 8), (32, 9, 8, 4, 8), (32, 100, 20, 4, 4)]
KERNEL_CASES += [(n, P, S, K, 8) for n, P, S, K, _ in CYNMIX_SHAPES
                 if (n, P, S, K, 8) not in KERNEL_CASES] \
    + [(32, 10, 4, 4, 8)] \
    + [(TEST1_SHAPE[0], P, TEST1_SHAPE[3], K, 8)
       for P, K in zip(*TEST1_SHAPE[1:3])]
# the protein and codon main paths' shapes (n_tips, P, S, K): avian under
# a gamma model (89 taxa, 88 patterns; the manual's aamodelpr=mixed run
# has K = 1, whose launches the CLI phase counts), replicase under M0 and
# NY98 (9 taxa, 239 codon patterns); each at 2 runs x 4 chains and at 32
# chains, all with their operators staged a step ahead
AA_CODON_SHAPES = [(89, 88, 20, 4), (89, 88, 20, 1), (9, 239, 61, 1),
                   (9, 239, 61, 3)]
KERNEL_CASES += [shape + (C,) for shape in AA_CODON_SHAPES for C in (8, 32)]
KERNEL_WALKS = {(6, 40, 61, 3): "staged", (9, 70, 32, 16): "tiled",
                (32, 100, 20, 4): "staged",
                **{shape: "staged" for shape in AA_CODON_SHAPES}}
# a stacked group on 9 tips, C = 4, whose members (P, S, K) take the
# global-scratch, staged and whole walks
STACKED_MIXED = ((70, 32, 16), (30, 61, 3), (40, 4, 4))
MULTIWALK_CASES = [TEST1_SHAPE + (8,), TEST1_SHAPE + (32,),
                   (12, (199, 258), (1, 4), 4, 8),
                   (12, (137, 40, 300), (4, 2, 1), 4, 4),
                   (6, (40, 64), (2, 1), 20, 4),
                   (6, (40, 23), (3, 1), 61, 2)]
WAVEFRONT_CASES = CYNMIX_SHAPES + [(24, 137, 4, 4, 8), (40, 300, 4, 1, 8),
                                   (24, 64, 2, 4, 4)]
WARM_GENS, BLOCK_GENS, SYNC_GENS = 50, 200, 50
# the sites mesh axis: shard counts of the kernel check, timed blocks of
# the sharded primates engine
SHARD_COUNTS, SHARD_BLOCKS = (1, 2, 4), 3
DEV = "cuda"
# the reference's envelope runs 20,000 generations; test1's default run is
# cut to leave room for test2's and the later phases' within 600 s (its
# 20,000-generation envelope is a separate call: --test1-gens 20000), and
# from 2,000 for the analyses phases within 700 s on a slow host
ENVELOPE_GENS = 20000
TEST1_GENS = 1000
TEST2_GENS = ENVELOPE_GENS
# the clock-tree kernel cases: test2's divisions (test1's, on a clock
# tree) at 8 and 32 chains
CLOCK_CHAINS = (8, 32)
# the prior-only clock check: runs x 1 chain, generations, the seeds of
# its two runs, and the draws of the direct sample it is held against
PRIOR_RUNS, PRIOR_GENS, PRIOR_SEEDS = 32, 3000, (11, 12)
PRIOR_DRAWS = 100000
# enough for sump/sumt samples (4 per run at samplefreq 100); cut from
# 2,000 to make room for the sharded phases within 600 s, and from 600 for
# the families phases within 700 s on a slow host
CYNMIX_GENS = 300
# one division's lnL between kernel paths on one state (the float32 total
# of 8 divisions near -36,117 is compared with the reference only: one
# float32 spacing there is 0.0039)
GOLDEN_PATH_TOL = 1e-3
AVIAN = os.path.join(EXAMPLES, "avian_ovomucoids.nex")
REPLICASE = os.path.join(EXAMPLES, "replicase.nex")
# eigh.cu's batches (matrices, S): avian's 8 and 32 chains, replicase
# NY98's 8 and 32 chains x 3 omega classes; its tolerance on
# |A - V diag(w) V^T| / |A| and on P(t) against the plain version
EIGH_CASES = [(8, 20), (32, 20), (24, 61), (96, 61)]
# ... and at S the runtime-S instantiation takes (other genetic codes have
# 60-62 codons)
EIGH_RUNTIME_CASES = [(8, 9), (8, 60), (8, 64)]
EIGH_TOL = 1e-10
# the protein and codon runs through the CLI (2 runs x 4 chains), and
# their prior-only check: runs x 1 chain, generations, seed (the three
# runs cut from 1,000, 2,000 and 2,000 to make room for the dating phases
# within 600 s, the CLI runs from 600 and 1,200 for the families phases,
# avian's from 300 for the analyses phases)
AA_GENS, CODON_GENS = 200, 600
AA_PRIOR_RUNS, AA_PRIOR_GENS, AA_PRIOR_SEED = 32, 1200, 13


# hymfossil (the dating slice): the kernel cases' chain counts, the CLI
# run's generations (4 samples a run at samplefreq 100; cut from 1,000,
# then from 600 for the analyses phases and from 400 for the multiproc
# phases), and the
# prior-only dating checks' runs x 1 chain and generations
HYM_CHAINS = (8, 32)
HYM_GENS = 300
DATING_PRIOR_RUNS, DATING_PRIOR_GENS = 32, 1000
# hymfossil's gens/s through the CLI before sampled ancestors were accepted,
# as PERF.md records it from the dating slice's chip runs: printed beside
# this run's on a log line, never measured here
HYM_GENS_PER_S_BEFORE = 34.9
# the three-tip prior-only FBD problem against its float64 integral
# (tests/fbd_small_trees.py): runs x 1 chain, generations, the first ones not
# read, seed
THREE_TIP_RUNS, THREE_TIP_GENS, THREE_TIP_BURN, THREE_TIP_SEED = \
    512, 600, 200, 1
# kim.nex's stem doublets, codon M3 and M10 and unlinked trees: pruning.cu
# at the new shapes (n_tips, P, S, K), each at C = 8 and 32: kim's stem
# doublets (78 pair patterns, S 16, K 1 and 4), its two proteins (S 20),
# replicase under M3 (K 3) and M10 (4 + 4 classes), and codon data on 114
# taxa (hymfossil's tree size) under M3 and M10; the size rule stages M3's
# operators on 9 taxa and sends M10 (K S = 488 entries a step, more than
# 32 lanes x 8) and the 114-taxon shapes (a step's operators and 57 live
# slots beyond a block) to the tiled walk (the global-scratch walk before
# it)
KIM_CODON_SHAPES = [(27, 78, 16, 1), (27, 78, 16, 4), (27, 68, 20, 1),
                    (27, 32, 20, 1), (9, 239, 61, 3), (9, 239, 61, 8),
                    (114, 240, 61, 3), (114, 240, 61, 8)]
KIM_CODON_WALKS = {(9, 239, 61, 3): "staged", (9, 239, 61, 8): "tiled",
                   (114, 240, 61, 3): "tiled", (114, 240, 61, 8): "tiled"}
# eigh.cu's batches (matrices, S): the doublet's 8 and 32 chains, M10's 8
# and 32 chains x 8 omega classes
KIM_EIGH_CASES = [(8, 16), (32, 16), (64, 61), (256, 61)]
GOLDEN_KIM_CODON = ("kim_hky_g_mixed4", "kim_stems_doublet_gtr",
                    "kim_protein_gtr", "replicase_m10")
# the CLI runs' generations, sampled every 50 (5 samples a run at 200;
# kim's and the unlinked run's cut from 300 for the analyses phases)
KIM_GENS, M10_GENS, M3_GENS, UNLINKED_GENS = 200, 400, 150, 200
KIM_SAMPLEFREQ = 50
# covarion, restriction data and directional root frequencies: the
# engines whose operands pruning.cu is held at (name -> data, model
# commands), each at C = 8 and 32: avian under Jones+G with the covarion
# model (89 tips, 88 patterns, S 40, K 4: the runtime-S staged walk),
# primates under HKY+G with it (12 tips, 413 patterns, S 8, K 4: the S 8
# template's whole walk), and the restriction matrix under directional
# root frequencies with equal and with gamma rates (6 tips, S 2, its two
# coding dummies among the patterns, K 1 and 4)
# (envelope.BATCHES entry, extra commands)
COVARION_ENGINES = {
    "avian_covarion": ("avian_covarion", ()),
    "primates_covarion": ("primates_covarion", ()),
    "restriction_directional": ("restriction_directional", ()),
    "restriction_directional_gamma": ("restriction_directional",
                                      ("lset rates=gamma",))}
COVARION_WALKS = {"avian_covarion": "staged", "primates_covarion": "whole",
                  "restriction_directional": "whole",
                  "restriction_directional_gamma": "whole"}
GOLDEN_COVARION = ("primates_covarion_hky", "restriction_directional",
                   "restriction_mixedfreq")
# the CLI runs (envelope.BATCHES): name -> (runs, generations), 4 chains
# each, sampled every 50
COVARION_CLI = {"primates_covarion": (2, 300), "avian_covarion": (1, 150),
                "restriction_directional": (1, 300),
                "restriction_mixed": (1, 300)}
COV_SAMPLEFREQ = 50
# the rest of the other likelihood families (lnorm, kmixture, adgamma,
# symdirihyperpr, parsmodel, continuous data): pruning.cu is held at the
# operands of cynmix's morphology under symdirihyperpr
# (envelope.BATCHES["cynmix_symdiri"]), each bucket at C = 8 and 32: the
# binary one's 5 beta x 4 gamma categories (32 tips, 124 patterns with
# the coding dummies, S 2, K 20) and the 3-, 4- and 8-state ones with
# their sampled frequencies (K 4), every one on the whole walk
FAMILY_KERNEL_DIVS = (0, 1, 2, 3)
# the CLI runs (envelope.BATCHES): name -> (runs, switches), 4 chains
# each, FAMILY_GENS generations sampled every FAMILY_SAMPLEFREQ; the .p
# column each adds (None: none)
FAMILY_CLI = {"primates_adgamma": (2, {}),
              "primates_lnorm_kmix": (1, {"multiwalk": True}),
              "cynmix_symdiri": (1, {}), "cynmix_parsmodel": (1, {}),
              "continuous": (1, {})}
FAMILY_COLUMNS = {"primates_adgamma": "corr",
                  "primates_lnorm_kmix": "mixturerates{2}[4]",
                  "cynmix_symdiri": None, "cynmix_parsmodel": None,
                  "continuous": "brownScale"}
# (generations cut from 300 for the analyses phases, and from 200 for the
# multiproc phases)
FAMILY_GENS, FAMILY_SAMPLEFREQ, FAMILY_SYNC_GENS = 150, 50, 20
# the identical-state check: chains; the tolerance of a family
# division's lnL per chain between the card's engine and the CPU's (the
# kernels against their plain versions; float64 sums of float32 site
# lnLs) and of each chain's lnL against the independent references; and
# the relative term the other divisions (cynmix's GTR+I+G genes) add to
# it: their float32 P(t) and root sums round differently on the two
# devices, by up to 1.03e-2 at |lnL| 8,198 on an H100 (1.26e-6 |lnL|;
# PERF.md)
FAMILY_STATE_CHAINS = 8
FAMILY_LNL_TOL = 2e-3
OTHER_LNL_REL = 1.3e-6


# the analyses group (report, steppingstone, start trees, commands,
# per-chain moves; phases 47-52): the report runs' generations, sampled
# every ANALYSES_SAMPLEFREQ; the ss run's generations, steps and sample
# interval; the power-0 block's burn-in and generations; the start-tree
# runs' generations; each timed per-chain block's generations
GOLDEN_ANC = os.path.join(HERE, "tests", "golden_ancstates.json")
REPORT_GENS, REPORT_CODON_GENS, ANALYSES_SAMPLEFREQ = 200, 100, 50
SS_GENS, SS_STEPS, SS_SAMPLEFREQ = 250, 5, 25
PRIOR_POWER_BURN, PRIOR_POWER_GENS = 200, 1000
START_GENS = 40
PER_CHAIN_GENS = 30
# the best group (phases 53-55): finch's BEST model through the CLI, its
# generations and sample interval; the gene-stack kernel's chain counts;
# the sync check's block
FINCH = os.path.join(EXAMPLES, "finch.nex")
BEST_GENS, BEST_SAMPLEFREQ = 300, 50
BEST_KERNEL_CHAINS = (8, 32)
BEST_SYNC_GENS = 20
# the two-gene primates shape of phase 53 (tests/test_best.py's engine
# smoke run: 12 taxa in 6 species of 2, sites 1-400 and 401-898)
PRIMATES_BEST = ("partition genes = 2: 1-400, 401-.",
                 "set partition=genes",
                 "speciespartition sp = A: 1-2, B: 3-4, C: 5-6, D: 7-8, "
                 "E: 9-10, F: 11-12",
                 "set speciespartition=sp", "lset nst=2",
                 "prset topologypr=speciestree brlenspr=clock:speciestree")


# the multiproc group (phases 56-58): the chains axis over two ranks of
# torch.distributed sharing the card.  The library phase's layouts (runs,
# chains) of primates GTR+I+G: (a) a run a rank, (b) one run of 8 chains,
# 4 a rank; its warm-up, timed blocks and generations a block, and the
# sync check's generations.  The CLI phase's
# generations of tests/test_multihost.py's DRIVE script.  A rank's
# collectives wait at most MULTIPROC_DIST_TIMEOUT s, and a launch of ranks
# at most MULTIPROC_TIMEOUT s before every rank is killed.
MULTIPROC_LAYOUTS = {"a_2x4": (2, 4), "b_1x8": (1, 8)}
MULTIPROC_WARM, MULTIPROC_BLOCKS, MULTIPROC_GENS = 20, 2, 100
MULTIPROC_SYNC_GENS = 20
MULTIPROC_CLI_GENS = 480
MULTIPROC_TIMEOUT, MULTIPROC_DIST_TIMEOUT = 240, 120
MULTIPROC_DRIVE = """#NEXUS
begin mrbayes;
    set autoclose=yes nowarnings=yes seed=21 swapseed=22;
    execute {primates};
    lset nst=2 rates=gamma;
    mcmc ngen={ngen} nruns=2 nchains=2 samplefreq=40 printfreq=120
         diagnfreq=120 checkfreq=120 file=dist;
    sumt;
    sump;
end;
"""
MULTIPROC_FILES = ("run1.p", "run2.p", "run1.t", "run2.t", "ckp", "mcmc",
                   "con.tre", "pstat", "trprobs")


def state_tol(lnl, family):
    """The card-vs-CPU bound of each division's lnL [C, n_div]: family
    divisions (``family`` [n_div] bool) within ``FAMILY_LNL_TOL``, the
    others within it plus ``OTHER_LNL_REL`` |lnL|."""
    return FAMILY_LNL_TOL + np.where(family, 0.0, OTHER_LNL_REL
                                     * np.abs(lnl))


def is_family_div(cfg):
    """True for a division of this group's families: lnorm, kmixture or
    adgamma rates, symdirihyperpr, the parsimony model, continuous data."""
    return (cfg.settings.rates in ("lnorm", "kmixture", "adgamma")
            or cfg.symdiri or not cfg.prunes)
# every kernel of the kernels line: name, route, source, the TPU kernel
KERNEL_IDS = [
    {"name": "pruning_down", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/pruning.cu",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:94"},
    {"name": "multiwalk_down", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/multiwalk.cu",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:144"},
    {"name": "wavefront_down", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/wavefront.cu",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:478"},
    {"name": "stacked_down", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/stacked.cu",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:767"},
    {"name": "sharded_down", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/pruning.cu + "
               "mrbayes_tpu_torch/ops/sharded_cuda.py",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:456"},
    {"name": "eigh_jacobi", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/eigh.cu",
     "replaces": "mrbayes_tpu/ops/tiprobs.py:33"},
    {"name": "stacked_down_gene_trees", "route": "cuda",
     "source": "mrbayes_tpu_torch/csrc/stacked.cu",
     "replaces": "mrbayes_tpu/ops/pruning_pallas.py:767"}]
# the numbers of the kernels line, measured only when every group runs
KERNEL_NUMBERS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms")
# the phase groups of --phases, in the order they run
PHASE_GROUPS = ("kernels", "primates", "test1", "cynmix", "sharded",
                "clock", "aa_codon", "dating", "kim_codon", "covarion",
                "families", "analyses", "best", "multiproc")


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_text):
    """[(kernel, registers, spill stores, spill loads)] per kernel
    instantiation in an ``nvcc -Xptxas -v`` log, a mangled name in a
    namespace cut to its identifier and template argument
    (``wavefront_kernel<4>``)."""
    import re
    out, name, spill = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            ns = re.match(r"_ZN(\d+)", name)
            if ns:
                rest = name[ns.end() + int(ns.group(1)):]
                ident = re.match(r"(\d+)", rest)
                n = int(ident.group(1))
                targ = re.match(r"ILi(\d+)E", rest[ident.end() + n:])
                name = rest[ident.end():ident.end() + n] + (
                    f"<{targ.group(1)}>" if targ else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


def tree_walks(torch, trees):
    """The trees on the card, one per chain: (order, left, right)."""
    from mrbayes_tpu_torch.ops.traversal import postorder_internal

    def stack(field):
        return torch.as_tensor(np.stack([getattr(t, field) for t in trees]),
                               device=DEV).long()

    left, right, parent = stack("left"), stack("right"), stack("parent")
    return postorder_internal(parent, trees[0].n_tips), left, right


def random_walks(torch, rng, n_tips, C):
    """Each chain's random tree on the card: (order, left, right)."""
    from mrbayes_tpu_torch.trees import random_unrooted
    trees = [random_unrooted(n_tips, rng, mean_blen=0.1) for _ in range(C)]
    return tree_walks(torch, trees)


def shaped_tree(shape, n_tips, rng):
    """A random, caterpillar or balanced tree in the package's layout
    (internal nodes from n_tips on, the root last).  A balanced tree pairs
    the nodes of each level and carries an odd one up."""
    from mrbayes_tpu_torch.trees import Tree, random_unrooted
    if shape == "random":
        return random_unrooted(n_tips, rng, mean_blen=0.1)
    n = 2 * n_tips - 1
    parent, left, right = (np.full(n, -1, np.int32) for _ in range(3))
    level, nxt = list(range(n_tips)), n_tips
    while len(level) > 1:
        k = 1 if shape == "caterpillar" else len(level) // 2
        up = []
        for a, b in zip(level[0:2 * k:2], level[1:2 * k:2]):
            left[nxt], right[nxt] = a, b
            parent[a] = parent[b] = nxt
            up.append(nxt)
            nxt += 1
        level = up + level[2 * k:]
    return Tree(parent=parent, left=left, right=right,
                blen=np.full(n, 0.1), n_tips=n_tips, rooted=False)


def random_operands(rng, n_tips, P, S, K, C):
    """0/1 tip partials, row-stochastic per-branch operators and a pi."""
    tips = (rng.random((n_tips, P, S)) < 0.4).astype(np.float32)
    tips[..., 0] = 1.0
    Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(np.float32) + 0.05
    Pm /= Pm.sum(-1, keepdims=True)
    pi = rng.random(S).astype(np.float32) + 0.2
    return tips, Pm, pi / pi.sum()


def kernel_case(torch, n_tips, P, S, K, C, seed):
    """Operands of one single-division kernel call from a seed."""
    from mrbayes_tpu_torch.ops.pruning_cuda import PruningCuda
    rng = np.random.default_rng(seed)
    order, left, right = random_walks(torch, rng, n_tips, C)
    tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
    pruner = PruningCuda(tips, K, torch.device(DEV))
    lr, pstep = pruner.operands(order, left, right,
                                torch.as_tensor(Pm, device=DEV))
    return lr, pstep, pruner.tips, torch.as_tensor(pi, device=DEV)


def multiwalk_case(torch, n_tips, Ps, Ks, S, C, seed):
    """Operands of one multiwalk call from a seed: the group's wiring,
    lr, the flat operators and one pi per division."""
    from mrbayes_tpu_torch.ops.multiwalk_cuda import PruningCudaMultiwalk
    rng = np.random.default_rng(seed)
    order, left, right = random_walks(torch, rng, n_tips, C)
    specs, P_list, pis = [], [], []
    for P, K in zip(Ps, Ks):
        tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
        specs.append((tips, K))
        P_list.append(torch.as_tensor(Pm, device=DEV))
        pis.append(torch.as_tensor(pi, device=DEV))
    group = PruningCudaMultiwalk(specs, torch.device(DEV))
    lr, pstep = group.operands(order, left, right, P_list)
    return group, lr, pstep, pis


def site_lnl(torch, root, ls, pi):
    """Per-pattern lnL [C, P] of root [C, K, S, P] and ls [C, P] under pi
    [S] or [C, S], or a category's own [C, K, S], with equal category
    weights."""
    K = root.shape[1]
    if pi.ndim == 3:
        return torch.log(torch.einsum("cksp,cks->cp", root, pi) / K) + ls
    pi = pi.expand(root.shape[0], -1)
    return torch.log(torch.einsum("cksp,cs->cp", root, pi) / K) + ls


def compare(torch, a, b, what):
    err = (a - b).abs()
    # a NaN or inf on either side counts as a mismatch
    bad = (~(err <= ATOL + RTOL * b.abs())).sum().item()
    log(f"{what}: max |dlnL| {err.max().item():.3e} (lnL range "
        f"{b.min().item():.1f}..{b.max().item():.1f}) "
        f"{'OK' if bad == 0 else 'MISMATCH'}")
    if bad:
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version at {bad} patterns")
    return err.max().item()


def time_events(torch, fn, n):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def time_graph(torch, fn, n=100, reps=5):
    """ms per call of ``fn`` (raw kernel launches that read the current
    stream when called) from CUDA events around replays of one CUDA graph
    of n calls: the device's time for back-to-back launches, with no host
    time between them (a Python loop of ctypes launches can take longer
    to enqueue a short kernel than the kernel takes to run)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * n)


def bound(nbytes, flops, flops_per_s=H100_FP32_FLOPS):
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def group_walk(torch, lay, lr, pstep, tips, walk=None):
    """A raw launch of a group's kernels (csrc/stacked.cu or
    csrc/multiwalk.cu through ``lay``, a GroupLayout) on preallocated flat
    outputs as ``lay.plan`` gives it (``walk="global"``: every division on
    the kept global-scratch kernel): the launch, the plan and the
    outputs."""
    C, dev = lr.shape[-3], lr.device
    plan = lay.plan(C, dev, walk)
    total = lay.offsets(C)[-1]
    scratch = torch.empty(plan["scratch"], device=dev) \
        if plan["scratch"] else None
    root = torch.empty(int(total[5]), device=dev)
    ls = torch.empty(int(total[6]), device=dev)

    def raw():
        lay.launch(lr, pstep, tips, plan, scratch, root, ls)
    return raw, plan, root, ls


def old_walk(torch, lr, pstep, tips, outputs=False):
    """The global-scratch walk of down_pass.cuh on the same operands, for
    the time the old walk takes: a raw multiwalk.cu launch at D = 1 whose
    plan forces its kept global-scratch kernel (one thread a pattern, the
    kernel of every multiwalk launch before the on-chip one).  With
    ``outputs`` also its root [C, K, S, P] and ls [C, P]."""
    from mrbayes_tpu_torch.ops import multiwalk_cuda as MW
    C, K, S = lr.shape[0], *pstep.shape[3:5]
    n_tips, _, P = tips.shape
    lay = MW.MultiwalkLayout(n_tips, S, [K], [P])
    raw, _, root, ls = group_walk(torch, lay, lr, pstep.reshape(-1),
                                  tips.reshape(-1), "global")
    if not outputs:
        return raw
    return raw, root.view(C, K, S, P), ls.view(C, P)


def new_walk(torch, lr, pstep, tips):
    """A raw pruning.cu launch on preallocated outputs on the operands'
    device (scratch only where the size rule gives the global-scratch
    walk), the rule's plan and the outputs."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    C, n_int, _, K, S = pstep.shape[:5]
    n_tips, _, P = tips.shape
    dev = lr.device
    plan = PC.pruning_plan(C, n_tips, K, S, P, dev)
    scratch = torch.empty((C, n_int, K, S, P), device=dev) \
        if plan["walk"] == "global" else None
    root = torch.empty((C, K, S, P), device=dev)
    ls = torch.empty((C, P), device=dev)

    def raw():
        PC.pruning_launch(lr, pstep, tips, scratch, root, ls, plan)
    return raw, plan, root, ls


def pruning_check(torch, shape, seed, expect=None, plain=False, n=100,
                  reps=5, loops=200, before_n=None, before_reps=None,
                  before_loops=None, case=None):
    """pruning.cu at one (n_tips, P, S, K, C) against its plain version on
    seeded operands: the walk and block the size rule chose (held to
    ``expect`` where given, and to its Python twin
    ``pruning_cuda.size_rule`` at an H100's limits), its CUDA-graph time
    and the old global-scratch walk's on the same operands (before_ms,
    ``before_n`` launches a graph and ``before_reps`` replays, n and reps
    unless given), the largest difference of root and ls to the old walk
    (vs_old_max_abs), the Python loops' times (``before_loops`` 0: the old
    walk's is not timed), the bound and, with ``plain``, the plain
    version's time.  ``case`` (lr, pstep, tips, pi) gives the operands
    (an engine's own) in place of seeded random ones.  Returns (record,
    operands, bytes, operations)."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    n_tips, P, S, K, C = shape
    lr, pstep, tips, pi = case or kernel_case(torch, n_tips, P, S, K, C,
                                              seed)
    root_k, ls_k = PC.pruning_down(lr, pstep, tips)
    torch.cuda.synchronize()
    root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
    raw, plan, root, ls = new_walk(torch, lr, pstep, tips)
    err = compare(
        torch, site_lnl(torch, root_k, ls_k, pi),
        site_lnl(torch, root_p, ls_p, pi),
        f"pruning_down n_tips={n_tips} P={P} S={S} K={K} C={C} "
        f"({plan['walk']} walk, {plan['threads']} threads for {plan['T']} "
        f"patterns, {plan['lanes']} lanes a pattern, cluster "
        f"{plan['cluster']}, {plan['smem_bytes']} B of shared memory)")
    if expect is not None and plan["walk"] != expect:
        raise AssertionError(f"pruning_down n_tips={n_tips} S={S} K={K}: "
                             f"{plan['walk']} walk, expected {expect}")
    twin = PC.size_rule(C, n_tips, K, S, P)
    if plan != twin:
        raise AssertionError(f"pruning_plan {plan} != size_rule {twin}")
    flops = 2 * C * (n_tips - 1) * 2 * K * S * S * P
    nbytes = 4 * (lr.numel() + pstep.numel() + tips.numel()
                  + root.numel() + ls.numel())
    before, root_o, ls_o = old_walk(torch, lr, pstep, tips, outputs=True)
    before()
    torch.cuda.synchronize()
    before_loops = loops if before_loops is None else before_loops
    rec = {**plan, "max_abs_err": err,
           "vs_old_max_abs": max((root_o - root_k).abs().max().item(),
                                 (ls_o - ls_k).abs().max().item()),
           "ms": time_graph(torch, raw, n, reps),
           "before_ms": time_graph(torch, before, before_n or n,
                                   before_reps or reps),
           "loop_ms": time_events(torch, raw, loops),
           "before_loop_ms": (time_events(torch, before, before_loops)
                              if before_loops else None),
           **{k: v for k, v in bound(nbytes, flops).items()
              if k in ("bound_ms", "bound_by")}}
    if plain:
        rec["plain_ms"] = time_events(
            torch, lambda: PC.pruning_down_plain(lr, pstep, tips), 5)
    log(f"pruning_down timing n_tips={n_tips} P={P} S={S} K={K} C={C}: "
        f"{json.dumps(rec)}")
    return rec, (lr, pstep, tips), nbytes, flops


def phase_kernels(torch):
    """pruning.cu against its plain version at every case, the walk and
    block the size rule gave it, and its time beside the old walk's
    (before_ms) and the bound; at primates' shape also the wrapper's and
    the plain version's times."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    worst = 0.0
    timing, cases = {}, {}
    for i, (n_tips, P, S, K, C) in enumerate(KERNEL_CASES):
        key = f"n{n_tips}_P{P}_S{S}_K{K}_C{C}"
        cases[key], (lr, pstep, tips), nbytes, flops = pruning_check(
            torch, (n_tips, P, S, K, C), 100 + i,
            KERNEL_WALKS.get((n_tips, P, S, K), "whole"),
            plain=(n_tips, P, S, K) in AA_CODON_SHAPES)
        worst = max(worst, cases[key]["max_abs_err"])
        if (n_tips, P, S, K) != (12, 413, 4, 4):
            continue
        # the wrapper (operand checks + allocation + launch) and the plain
        # version at primates' shape
        timing[C] = {
            **cases[key],
            "wrapper_ms": time_events(
                torch, lambda: PC.pruning_down(lr, pstep, tips), 200),
            "plain_ms": time_events(
                torch, lambda: PC.pruning_down_plain(lr, pstep, tips), 20),
            **bound(nbytes, flops)}
        log(f"pruning_down timing primates C={C}: {json.dumps(timing[C])}")
    return worst, timing, cases


def phase_multiwalk_kernels(torch):
    """multiwalk.cu against its plain version at every case and division,
    with the walk the plan gave each division; at test1's shape its time
    beside pruning.cu once per division, the same group through stacked.cu
    and the old walk (before_ms: the kept global-scratch kernel, forced by
    the plan), CUDA-graph timed, with the Python loop's times beside."""
    from mrbayes_tpu_torch.ops import multiwalk_cuda as MW
    from mrbayes_tpu_torch.ops.stacked_cuda import StackedLayout
    worst = 0.0
    timing = {}
    log("multiwalk: mixed S in one group is not a case: the engine groups "
        "divisions by state count (csrc/multiwalk.cu)")
    for i, (n_tips, Ps, Ks, S, C) in enumerate(MULTIWALK_CASES):
        group, lr, pstep, pis = multiwalk_case(torch, n_tips, Ps, Ks, S, C,
                                               200 + i)
        lay = group.layout
        root_k, ls_k = MW.multiwalk_down(lr, pstep, group.tips, lay)
        torch.cuda.synchronize()
        root_p, ls_p = MW.multiwalk_down_plain(lr, pstep, group.tips, lay)
        plan = lay.plan(C, lr.device)
        for d in range(lay.D):
            worst = max(worst, compare(
                torch, site_lnl(torch, *lay.div_view(root_k, ls_k, d), pis[d]),
                site_lnl(torch, *lay.div_view(root_p, ls_p, d), pis[d]),
                f"multiwalk_down n_tips={n_tips} P={Ps} K={Ks} S={S} C={C} "
                f"division {d} ({plan['walks'][d]} walk, {plan['threads']} "
                f"threads for {plan['T'][d]} patterns, {plan['lanes'][d]} "
                f"lanes a pattern, {plan['smem_bytes']} B)"))
        if (n_tips, Ps, Ks, S) != TEST1_SHAPE:
            continue
        n_int = n_tips - 1
        tips = group.tips
        raw, _, root, ls = group_walk(torch, lay, lr, pstep, tips)
        before = group_walk(torch, lay, lr, pstep, tips, "global")[0]
        stacked = group_walk(torch, StackedLayout(n_tips, lay.ks, lay.ss,
                                                  lay.ps),
                             lr, pstep, tips)[0]
        # the same work as one single-division launch per division
        per_div = [new_walk(torch, lr, *(x.contiguous() for x in
                                         lay.div_operands(pstep, tips, C, d)))
                   for d in range(lay.D)]

        def per_division():
            for fn, *_ in per_div:
                fn()

        flops = sum(2 * C * n_int * 2 * K * S * S * P
                    for K, P in zip(lay.ks, lay.ps))
        timing[C] = {
            **{k: plan[k] for k in ("walks", "threads", "T", "lanes",
                                    "smem_bytes")},
            "ms": time_graph(torch, raw),
            "loop_ms": time_events(torch, raw, 500),
            "before_ms": time_graph(torch, before),
            "stacked_same_work_ms": time_graph(torch, stacked),
            "pruning_down_per_division_ms": time_graph(torch, per_division),
            "pruning_down_per_division_loop_ms": time_events(
                torch, per_division, 500),
            "wrapper_ms": time_events(
                torch, lambda: MW.multiwalk_down(lr, pstep, tips, lay), 200),
            "plain_ms": time_events(
                torch, lambda: MW.multiwalk_down_plain(lr, pstep, tips, lay),
                20),
            **bound(4 * (lr.numel() + pstep.numel() + tips.numel()
                         + root.numel() + ls.numel()
                         + plan["tiles"].numel())
                    + 8 * plan["table"].numel(), flops)}
        log(f"multiwalk_down timing test1 C={C}: {json.dumps(timing[C])}")
    return worst, timing


def primates_dataset():
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file
    nf = read_nexus_file(PRIMATES)
    return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                   divisions=make_divisions(nf.matrix))


def sync_checked(torch, eng, states, bk, n_gens):
    """A block and one generation of each move type with host
    synchronisation made an error (outside any counted run)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, bk = eng.run_block(states, bk, n_gens)
        heats = 1.0 / (1.0 + eng.mcmc.temp * bk["temp_id"].float())
        u = torch.rand((eng.mcmc.n_chains_total,), generator=bk["rng"],
                       device=DEV)
        for m in range(len(eng.moves)):
            eng._chain_step(bk["rng"], states, heats, bk["tuning"][:, m],
                            1.0, m, u)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return states, bk


def assert_carried(eng, states, bk):
    """The cold chain's carried lnL and prior components against a
    recompute from scratch: every cached eigensystem dropped and rebuilt
    from the state's parameters (a cache a move left stale shows here)."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    cold = eng.cold_indices(bk)[0]
    fresh = eng.score(eng.refresh_eigs(
        {k: v for k, v in states.items()
         if k not in SCORE_KEYS and not k.startswith("eig")}))
    for k in ("lnL", "lnP_tree", "lnP_par"):
        a, b = states[k][cold].item(), fresh[k][cold].item()
        if abs(a - b) > 1e-3 + 1e-6 * abs(b):
            raise AssertionError(f"carried {k} {a} != recomputed {b}")
    return cold


def phase_primates(torch, ds, nchains, blocks, power_line):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=nchains, seed=3),
                 device=DEV)
    states, bk = eng.init_chains()
    states, bk = eng.run_block(states, bk, WARM_GENS)
    torch.cuda.synchronize()
    pruner = eng._pruners[0]
    pruner.launches = 0                      # the main path's run starts
    rates = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        states, bk = eng.run_block(states, bk, BLOCK_GENS)
        torch.cuda.synchronize()
        rates.append(BLOCK_GENS / (time.perf_counter() - t0))
    launches = pruner.launches               # ... and ends here
    gens = blocks * BLOCK_GENS
    if launches < gens:
        raise AssertionError(f"{launches} kernel launches for {gens} "
                             f"generations")
    states, bk = sync_checked(torch, eng, states, bk, SYNC_GENS)
    max_lnl = states["lnL"].max().item()
    if not max_lnl > -8500.0:
        raise AssertionError(f"max lnL {max_lnl} <= -8500")
    cold = assert_carried(eng, states, bk)
    rate = float(np.median(rates))
    log(f"primates GTR+I+G {nchains} chains: median {rate:.1f} gens/s over "
        f"{blocks} blocks of {BLOCK_GENS} gens (min {min(rates):.1f}, max "
        f"{max(rates):.1f}), max lnL {max_lnl:.2f}, cold lnL "
        f"{states['lnL'][cold].item():.3f}, pruning_down launches "
        f"{launches} for {gens} gens, no host sync in a {SYNC_GENS}-gen "
        f"block or in any of the {len(eng.moves)} move types; card "
        f"{power_line}")
    return {"gens_per_s": rate, "gens_per_s_blocks": rates,
            "launches": launches, "gens": gens, "max_lnL": max_lnl}


def phase_golden(torch, ds):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN)) if r["model"] == "gtr_ig"]
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                 mcmc=McmcSettings(nruns=1, nchains=1), device=DEV)
    worst = 0.0
    for rec in rows:
        st = tree_state(torch, parse_newick(rec["newick"], ds.taxa))
        for k, f in (("pi", "pi"), ("revmat", "revmat")):
            st[k] = torch.tensor([[rec[f]]], dtype=torch.float32,
                                 device=DEV)
        st["shape"] = torch.tensor([[rec["alpha"]]], device=DEV)
        st["pinvar"] = torch.tensor([[rec["pinvar"]]], device=DEV)
        lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
        worst = max(worst, abs(lnl - rec["lnL"]))
        if abs(lnl - rec["lnL"]) >= 0.35:
            raise AssertionError(f"golden gtr_ig lnL {lnl} vs reference "
                                 f"{rec['lnL']}")
    log(f"golden gtr_ig: {len(rows)} rows, max |lnL - reference| "
        f"{worst:.4f} (limit 0.35)")
    return worst


def tree_state(torch, t):
    st = {k: torch.as_tensor(np.asarray(getattr(t, k))[None],
                             device=DEV).long()
          for k in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(np.asarray(t.blen, np.float32)[None],
                                 device=DEV)
    return st


def phase_test1(torch, ngen, power_line, name="test1"):
    """test1 (or test2, its relaxed-clock twin) through the CLI with the
    multiwalk switch on.  The engine is built inside ``execute_file``, so
    its launch counts start at 0 there and are read when the run is over.
    Below 20,000 generations the envelope gives way to a best lnL above
    -5800."""
    from mrbayes_tpu_torch.envelope import envelope_errors, run_batch
    workdir = os.path.join(OUT, name)
    shutil.rmtree(workdir, ignore_errors=True)
    it, stats, lines = run_batch(name, workdir, ngen, device=DEV,
                                 multiwalk=True)
    runner = it._last_runner
    eng = runner.eng
    groups = eng._multiwalk_pruners
    if len(groups) != 1 or groups[0][0] != [0, 1]:
        raise AssertionError(f"expected {name}'s two divisions in one "
                             f"multiwalk group, got "
                             f"{[g for g, _ in groups]}")
    mw_launches = groups[0][1].launches
    pd_launches = sum(p.launches for p in eng._pruners)
    if mw_launches < ngen:
        raise AssertionError(f"{mw_launches} multiwalk launches for {ngen} "
                             f"generations")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Model probabilities for gtrsubmodel",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    n_rows = []
    rooting = "[&R]" if eng.tree_settings.clock else "[&U]"
    for r in (1, 2):
        with open(os.path.join(workdir, f"{name}.run{r}.p")) as f:
            n_rows.append(sum(1 for ln in f if ln[:1].isdigit()))
        with open(os.path.join(workdir, f"{name}.run{r}.t")) as f:
            text = f.read()
        if not text.rstrip().endswith("end;") \
                or text.count("tree gen.") != n_rows[-1] \
                or text.count(f"= {rooting} (") != n_rows[-1]:
            raise AssertionError(f"incomplete {name}.run{r}.t")
    expect_rows = ngen // eng.mcmc.samplefreq + 1
    if n_rows != [expect_rows] * 2:
        raise AssertionError(f".p rows {n_rows}, expected {expect_rows}")
    if ngen >= ENVELOPE_GENS:
        errors = envelope_errors(stats)
    else:
        errors = ([] if stats["best_lnl"] > -5800.0 else
                  [f"best lnL {stats['best_lnl']:.2f} <= -5800"])
    log(f"{name} through the CLI, multiwalk on: {json.dumps(stats)}; "
        f"multiwalk launches {mw_launches}, pruning_down launches "
        f"{pd_launches}, for {ngen} gens; card {power_line}")
    if errors:
        raise AssertionError(f"{name} outside its envelope: {errors}")
    return it, {**stats, "multiwalk_launches": mw_launches,
                "pruning_down_launches": pd_launches}


def phase_switch(torch, it, blocks, power_line, name="test1"):
    """gens/s of the test1 (or test2) engine with the switch off and on,
    in turns, and the sync check of every move type, switch on."""
    engines = {sw: it.build_engine(multiwalk=sw) for sw in (False, True)}
    runs = {}
    for sw, eng in engines.items():
        states, bk = eng.init_chains()
        states, bk = eng.run_block(states, bk, WARM_GENS)
        runs[sw] = [states, bk]
    torch.cuda.synchronize()
    pr = engines[False]._pruners
    for p in pr:
        p.launches = 0                       # the switch-off run starts
    rates = {False: [], True: []}
    for b in range(blocks):
        for sw in ((False, True) if b % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            runs[sw] = list(engines[sw].run_block(*runs[sw], BLOCK_GENS))
            torch.cuda.synchronize()
            rates[sw].append(BLOCK_GENS / (time.perf_counter() - t0))
    off_launches = sum(p.launches for p in pr)   # ... and ends here
    if off_launches < 2 * blocks * BLOCK_GENS:
        raise AssertionError(f"{off_launches} pruning_down launches for "
                             f"{blocks * BLOCK_GENS} gens x 2 divisions")
    out = {"off": float(np.median(rates[False])),
           "on": float(np.median(rates[True])),
           "off_blocks": rates[False], "on_blocks": rates[True],
           "pruning_down_launches_off": off_launches}
    log(f"{name} switch off/on, {blocks} blocks of {BLOCK_GENS} gens each, "
        f"in turns: {json.dumps(out)}; card {power_line}")
    eng = engines[True]
    sync_checked(torch, eng, *runs[True], SYNC_GENS)
    names = ", ".join(m.name for m in eng.moves)
    log(f"{name}: no host sync in a {SYNC_GENS}-gen block or in any of the "
        f"{len(eng.moves)} move types ({names})")
    return out


def phase_golden_partitioned(torch):
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] == "primates_part2_unlinked_gtr_g"]
    it = Interpreter(log=lambda m: None, device=DEV)
    for c in rows[0]["commands"]:
        it.run_line(c.replace("/root/reference/examples", EXAMPLES))
    worst = {}
    for sw in (False, True):
        eng = it.build_engine(multiwalk=sw)
        worst[sw] = 0.0
        for rec in rows:
            st = tree_state(torch, parse_newick(rec["newick"], eng.data.taxa))
            for k, v in rec["state"].items():
                st[k] = torch.tensor([v], dtype=torch.float32, device=DEV)
            lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
            worst[sw] = max(worst[sw], abs(lnl - rec["lnL"]))
            if abs(lnl - rec["lnL"]) >= rec["tol"]:
                raise AssertionError(
                    f"golden {rec['name']}@{rec['gen']} (multiwalk {sw}): "
                    f"lnL {lnl} vs reference {rec['lnL']}")
    log(f"golden primates_part2_unlinked_gtr_g: {len(rows)} rows, max "
        f"|lnL - reference| {worst[False]:.4f} per division, "
        f"{worst[True]:.4f} multiwalk (limit {rows[0]['tol']})")
    return worst


def wavefront_case(torch, shape, n_tips, P, S, K, W, C, seed):
    """One wavefront call from a seed: its wiring, its operands (lr, pstep:
    PruningCuda's), the chains' (order, left, right) and operators Pm, and
    a pi."""
    from mrbayes_tpu_torch.ops.wavefront_cuda import PruningCudaWavefront
    rng = np.random.default_rng(seed)
    walk = tree_walks(torch, [shaped_tree(shape, n_tips, rng)
                              for _ in range(C)])
    tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
    pruner = PruningCudaWavefront(tips, K, torch.device(DEV), W=W)
    Pm = torch.as_tensor(Pm, device=DEV)
    lr, pstep = pruner.operands(*walk, Pm)
    return pruner, lr, pstep, walk, Pm, tips, torch.as_tensor(pi, device=DEV)


def rows_mean(lr, n_tips, W):
    """The mean row count of the chains' schedules (the kernel's, through
    its twin row_schedule)."""
    from mrbayes_tpu_torch.ops.wavefront_cuda import row_schedule
    return float(np.mean([len(row_schedule(x, n_tips, W)[1]) - 1
                          for x in lr.cpu().numpy()]))


def wavefront_timing(torch, pruner, lr, pstep, walk, Pm, tips_host, W, plan):
    """The wavefront kernel's time (raw launches on preallocated outputs,
    CUDA graph and loop), pruning.cu's on the same operands, the old walk's
    (before_ms), the wrapper's, the operands' (the wavefront wiring's and
    PruningCuda's: the same function now that the kernel builds its rows)
    and the plain version's, beside the bound of this call's work."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops import wavefront_cuda as WF
    tips = pruner.tips
    C, n_int, _, K, S = pstep.shape[:5]
    n_tips, _, P = tips.shape
    root = torch.empty((C, K, S, P), device=DEV)
    ls = torch.empty((C, P), device=DEV)
    single = PC.PruningCuda(tips_host, K, torch.device(DEV))
    raw_pruning = new_walk(torch, lr, pstep, tips)[0]

    def raw():
        WF.wavefront_launch(lr, pstep, tips, root, ls, W, plan)

    nbytes = 4 * (lr.numel() + pstep.numel() + tips.numel() + root.numel()
                  + ls.numel())
    return {**plan,
            "ms": time_graph(torch, raw),
            "loop_ms": time_events(torch, raw, 500),
            "pruning_down_same_work_ms": time_graph(torch, raw_pruning),
            "pruning_down_same_work_loop_ms": time_events(torch, raw_pruning,
                                                          500),
            "before_ms": time_graph(torch, old_walk(torch, lr, pstep, tips)),
            "wrapper_ms": time_events(
                torch, lambda: WF.wavefront_down(lr, pstep, tips, W), 200),
            "schedule_and_operands_ms": time_events(
                torch, lambda: pruner.operands(*walk, Pm), 200),
            "pruning_operands_ms": time_events(
                torch, lambda: single.operands(*walk, Pm), 200),
            "plain_ms": time_events(
                torch, lambda: WF.wavefront_down_plain(lr, pstep, tips, W),
                10),
            "rows_mean": rows_mean(lr, n_tips, W), "n_int": n_int,
            **bound(nbytes, 2 * C * n_int * 2 * K * S * S * P)}


def phase_wavefront_kernels(torch):
    """The wavefront kernel against its plain version at every case, C and
    tree shape (and its root partials against pruning.cu's on the same
    operands, which the same arithmetic should give bit for bit); times
    at cynmix's division shapes (C = 8, random trees)."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops import wavefront_cuda as WF
    worst, root_diff, timing, seed = 0.0, 0.0, {}, 300
    for n_tips, P, S, K, W in WAVEFRONT_CASES:
        for C in (8, 32):
            for shape in ("random", "caterpillar", "balanced"):
                seed += 1
                pruner, lr, pstep, walk, Pm, tips, pi = wavefront_case(
                    torch, shape, n_tips, P, S, K, W, C, seed)
                root_k, ls_k = WF.wavefront_down(lr, pstep, pruner.tips, W)
                torch.cuda.synchronize()
                root_p, ls_p = WF.wavefront_down_plain(lr, pstep, pruner.tips,
                                                       W)
                root_s, _ = PC.pruning_down(lr, pstep, pruner.tips)
                diff = (root_k - root_s).abs().max().item()
                root_diff = max(root_diff, diff)
                plan = WF.wavefront_plan(C, n_tips, K, S, P, W, lr.device)
                worst = max(worst, compare(
                    torch, site_lnl(torch, root_k, ls_k, pi),
                    site_lnl(torch, root_p, ls_p, pi),
                    f"wavefront_down {shape} n_tips={n_tips} P={P} S={S} "
                    f"K={K} W={W} C={C}: {rows_mean(lr, n_tips, W):.1f} rows "
                    f"of n_int {n_tips - 1} ({plan['walk']} walk, "
                    f"{plan['threads']} threads in {plan['groups']} groups "
                    f"for {plan['T']} patterns, {plan['lanes']} lanes a "
                    f"pattern, {plan['smem_bytes']} B); root vs pruning.cu "
                    f"max |d| {diff:.3e}"))
                if shape == "random" and C == 8 \
                        and (n_tips, P, S, K, W) in CYNMIX_SHAPES:
                    timing[P] = wavefront_timing(torch, pruner, lr, pstep,
                                                 walk, Pm, tips, W, plan)
                    log(f"wavefront_down timing cynmix P={P} S={S} K={K} "
                        f"C={C}: {json.dumps(timing[P])}")
                elif P == 537:
                    # COI's other trees and chain count, beside pruning.cu
                    root = torch.empty_like(root_k)
                    ls = torch.empty_like(ls_k)
                    timing[f"P={P} C={C} {shape}"] = {
                        **plan, "rows_mean": rows_mean(lr, n_tips, W),
                        "ms": time_graph(torch, lambda: WF.wavefront_launch(
                            lr, pstep, pruner.tips, root, ls, W, plan)),
                        "pruning_down_same_work_ms": time_graph(
                            torch, new_walk(torch, lr, pstep,
                                            pruner.tips)[0])}
                    log(f"wavefront_down timing cynmix P={P} C={C} {shape}: "
                        f"{json.dumps(timing[f'P={P} C={C} {shape}'])}")
    log(f"wavefront_down: root partials against pruning.cu's on the same "
        f"operands, max |d| {root_diff:.3e} over every case")
    return worst, timing, root_diff


def cynmix_interpreter(chains=4, seed=7):
    """The CLI with cynmix's favored model read in (2 runs x ``chains``);
    every kernel-path switch off unless ``build_engine`` turns it on."""
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.envelope import BATCHES
    data, model = BATCHES["cynmix"]
    it = Interpreter(log=lambda m: None, device=DEV, multiwalk=False,
                     wavefront=False, stacked=False)
    for line in (f"execute {data}", *model,
                 f"mcmcp nruns=2 nchains={chains} seed={seed}"):
        it.run_line(line)
    return it


def dense_union(torch, stack, pstep, tips, C):
    """The old stacked launch's operands, built here only to time it: the
    members' operators on the diagonal of one block-diagonal
    [ΣK_d·S_d]² operator per step at K = 1, and their tips on one union
    state axis.  Returns (pstep [C, n_int, 2, 1, KS, KS], tips
    [n_tips, KS, ΣP_d])."""
    lay = stack.layout
    KS = sum(k * s for k, s in zip(lay.ks, lay.ss))
    P = sum(lay.ps)
    upst = torch.zeros((C, lay.n_int, 2, 1, KS, KS), device=DEV)
    utips = torch.zeros((lay.n_tips, KS, P), device=DEV)
    b = p0 = 0
    for d, (k, S, Pd) in enumerate(zip(lay.ks, lay.ss, lay.ps)):
        pst, tp = lay.div_operands(pstep, tips, C, d)
        for c in range(k):
            o = b + c * S
            upst[:, :, :, 0, o:o + S, o:o + S] = pst[:, :, :, c]
            utips[:, o:o + S, p0:p0 + Pd] = tp
        b, p0 = b + k * S, p0 + Pd
    return upst, utips


def stacked_mixed(torch):
    """A synthetic stacked group (STACKED_MIXED) whose members take the
    global-scratch, staged and whole walks in one launch, each member
    against the plain version: (max |dlnL|, the walks)."""
    from mrbayes_tpu_torch.ops import stacked_cuda as SC
    rng = np.random.default_rng(600)
    walk = random_walks(torch, rng, 9, 4)
    specs, P_list, pis = [], [], []
    for P, S, K in STACKED_MIXED:
        tips, Pm, pi = random_operands(rng, 9, P, S, K, 4)
        specs.append((tips, K))
        P_list.append(torch.as_tensor(Pm, device=DEV))
        pis.append(torch.as_tensor(pi, device=DEV))
    group = SC.PruningCudaStacked(specs, torch.device(DEV))
    lay = group.layout
    lr, pstep = group.operands(*walk, P_list)
    root_k, ls_k = SC.stacked_down(lr, pstep, group.tips, lay)
    torch.cuda.synchronize()
    root_p, ls_p = SC.stacked_down_plain(lr, pstep, group.tips, lay)
    walks = lay.plan(4, lr.device)["walks"]
    if walks != ["global", "staged", "whole"]:
        raise AssertionError(f"stacked mixed group walks {walks}")
    worst = 0.0
    for d, (P, S, K) in enumerate(STACKED_MIXED):
        worst = max(worst, compare(
            torch, site_lnl(torch, *lay.div_view(root_k, ls_k, d), pis[d]),
            site_lnl(torch, *lay.div_view(root_p, ls_p, d), pis[d]),
            f"stacked_down mixed group member {d} (P={P} S={S} K={K}, "
            f"{walks[d]} walk) vs plain"))
    return worst, walks


def phase_stacked(torch):
    """The stacked kernel (csrc/stacked.cu) on cynmix's group [0, 1, 2, 3,
    5] at 2 runs x 4 chains against its plain version and against each
    member's own pruning.cu launch, per division; its time beside five
    pruning.cu launches, its plain version's, and the old dense-union
    launch's (before_ms: the union assembled here and run through the old
    walk, multiwalk.cu at D = 1)."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops import stacked_cuda as SC
    from mrbayes_tpu_torch.ops.pruning import branch_tiprobs
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    eng = cynmix_interpreter().build_engine(stacked=True)
    (g, stack), = eng._stacked_pruners
    lay = stack.layout
    if g != [0, 1, 2, 3, 5] or list(zip(lay.ks, lay.ss, lay.ps)) != [
            (4, 2, 124), (4, 3, 34), (4, 4, 10), (4, 8, 9), (4, 4, 125)]:
        raise AssertionError(f"cynmix stacked group {g}: (K, S, P) "
                             f"{list(zip(lay.ks, lay.ss, lay.ps))}")
    states = eng.refresh_eigs(eng.init_chains()[0])
    P_list, pis = [], []
    for i in g:
        pi, _, lam, U, Uinv, rates, pinv, cmask, mult = \
            eng._generic_div_params(states, i)
        P_list.append(branch_tiprobs(states["blen"], lam, U, Uinv, rates,
                                     pinv if cmask is not None else 0.0,
                                     mult))
        pis.append(pi)
    walk = (postorder_internal(states["parent"], eng.n_tips),
            states["left"], states["right"])
    lr, pstep = stack.operands(*walk, P_list)
    root_k, ls_k = SC.stacked_down(lr, pstep, stack.tips, lay)
    torch.cuda.synchronize()
    root_p, ls_p = SC.stacked_down_plain(lr, pstep, stack.tips, lay)
    C, n_int = lr.shape[:2]
    plan = lay.plan(C, lr.device)
    worst = 0.0
    singles = []
    for d, i in enumerate(g):
        a = site_lnl(torch, *lay.div_view(root_k, ls_k, d), pis[d])
        worst = max(worst, compare(
            torch, a, site_lnl(torch, *lay.div_view(root_p, ls_p, d), pis[d]),
            f"stacked_down division {i} (K={lay.ks[d]} S={lay.ss[d]} "
            f"P={lay.ps[d]}, {plan['walks'][d]} walk, T={plan['T'][d]}) vs "
            f"plain"))
        single = eng._pruners[i]
        lr1, pst1 = single.operands(*walk, P_list[d])
        root1, ls1 = PC.pruning_down(lr1, pst1, single.tips)
        worst = max(worst, compare(
            torch, a, site_lnl(torch, root1, ls1, pis[d]),
            f"stacked_down division {i} vs its own pruning_down launch"))
        singles.append(new_walk(torch, lr1, pst1, single.tips)[0])
    err_mixed, mixed_walks = stacked_mixed(torch)
    worst = max(worst, err_mixed)
    raw = group_walk(torch, lay, lr, pstep, stack.tips)[0]
    tiles = plan["tiles"]

    def per_division():
        for fn in singles:
            fn()

    upst, utips = dense_union(torch, stack, pstep, stack.tips, C)
    divs = list(zip(lay.ks, lay.ss, lay.ps))
    own = bound(4 * (lr.numel() + pstep.numel() + stack.tips.numel()
                     + root_k.numel() + ls_k.numel()),
                2 * C * n_int * 2 * sum(k * S * S * P for k, S, P in divs))
    out = {"mixed_walks": mixed_walks,
           "threads": plan["threads"], "T": plan["T"],
           "lanes": plan["lanes"], "smem_bytes": plan["smem_bytes"],
           "walks": plan["walks"],
           "tiles": int(tiles.shape[0]),
           "ms": time_graph(torch, raw),
           "before_ms": time_graph(torch, old_walk(torch, lr, upst, utips),
                                   10, 2),
           "loop_ms": time_events(torch, raw, 500),
           "operands_ms": time_events(
               torch, lambda: stack.operands(*walk, P_list), 200),
           "plain_ms": time_events(
               torch, lambda: SC.stacked_down_plain(lr, pstep, stack.tips,
                                                    lay), 10),
           "pruning_down_per_division_ms": time_graph(torch, per_division),
           "per_division_operands_ms": time_events(
               torch, lambda: [eng._pruners[i].operands(*walk, P_list[d])
                               for d, i in enumerate(g)], 100),
           **own}
    log(f"stacked_down timing cynmix group {g} C={C}: {json.dumps(out)}")
    return worst, out


def phase_golden_cynmix(torch, shard_devices):
    """The cynmix_mkv_f81 golden rows (Mkv on the standard buckets, F81 on
    the DNA) through every kernel path, the site-sharded one over
    ``shard_devices`` included: each path's total within 0.25 of
    reference MrBayes (tests/test_golden.py's limit), each division's lnL
    within GOLDEN_PATH_TOL of the other paths', each path's kernel
    launched."""
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.envelope import CYNMIX
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    from mrbayes_tpu_torch.nexus.datatypes import DataType
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file
    from mrbayes_tpu_torch.ops.wavefront_cuda import PruningCudaWavefront
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN))
            if r["model"] == "cynmix_mkv_f81"]
    nf = read_nexus_file(CYNMIX)
    ds = DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                 divisions=make_divisions(nf.matrix))
    sets = [DivisionSettings(coding="variable", rates="equal")
            if d.dtype is DataType.STANDARD
            else DivisionSettings(nst="1", rates="equal")
            for d in ds.divisions]
    off = dict(multiwalk=False, wavefront=False, stacked=False)
    lnl, per_div = {}, {}
    for path in ("off", "wavefront", "stacked", "multiwalk", "sharded"):
        eng = Engine(ds, sets, mcmc=McmcSettings(nruns=1, nchains=1),
                     device=DEV, **{**off, **({path: True} if path in (
                         "wavefront", "stacked", "multiwalk") else {})})
        if path == "sharded":
            shard_engine_data(eng, make_mesh(1, len(shard_devices),
                                             shard_devices))
        lnl[path], per_div[path] = [], []
        for rec in rows:
            st = tree_state(torch, parse_newick(rec["newick"], ds.taxa))
            st["pi"] = torch.tensor([[rec["pi"]]], device=DEV)
            st = eng.refresh_eigs(st)
            lnl[path].append(eng.log_likelihood(st)[0].item())
            per_div[path].append(eng.division_lnls(st)[0].cpu())
        used = {"off": [p for p in eng._pruners
                        if not isinstance(p, PruningCudaWavefront)],
                "wavefront": [p for p in eng._pruners
                              if isinstance(p, PruningCudaWavefront)],
                "stacked": [p for _, p in eng._stacked_pruners],
                "multiwalk": [p for _, p in eng._multiwalk_pruners],
                "sharded": eng._pruners + [
                    p.dummy for p in eng._pruners
                    if getattr(p, "dummy", None) is not None]}[path]
        if not used or min(p.launches for p in used) < 2 * len(rows):
            raise AssertionError(f"golden cynmix, {path} path: its kernel "
                                 f"was not launched for every row")
    worst = max(abs(v - rec["lnL"]) for vals in lnl.values()
                for v, rec in zip(vals, rows))
    # per row and division, the largest difference between two paths
    spread = 0.0
    for r in range(len(rows)):
        t = torch.stack([v[r] for v in per_div.values()])   # [paths, n_div]
        spread = max(spread, float((t.max(0).values - t.min(0).values).max()))
    log(f"golden cynmix_mkv_f81: {len(rows)} rows, lnL by path "
        f"{json.dumps(lnl)}, reference {[r['lnL'] for r in rows]}, max "
        f"|lnL - reference| {worst:.4f} (limit 0.25), max spread of one "
        f"division's lnL between paths {spread:.2e} (limit "
        f"{GOLDEN_PATH_TOL})")
    if worst >= 0.25 or spread > GOLDEN_PATH_TOL:
        raise AssertionError("golden cynmix rows outside their limits")
    return worst, spread


def phase_cynmix(torch, ngen, power_line):
    """cynmix's favored model through the CLI with the wavefront and
    stacked switches on.  The engine is built inside ``execute_file``, so
    its launch counts start at 0 there and are read when the run is
    over."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.ops.wavefront_cuda import PruningCudaWavefront
    workdir = os.path.join(OUT, "cynmix")
    shutil.rmtree(workdir, ignore_errors=True)
    it, stats, lines = run_batch(
        "cynmix", workdir, ngen, device=DEV, diagnfreq=min(1000, ngen),
        multiwalk=False, wavefront=True, stacked=True)
    runner = it._last_runner
    eng = runner.eng
    groups = [g for g, _ in eng._stacked_pruners]
    if groups != [[0, 1, 2, 3, 5]] or not all(
            isinstance(p, PruningCudaWavefront) for p in eng._pruners):
        raise AssertionError(f"cynmix grouping: stacked {groups}, pruners "
                             f"{[type(p).__name__ for p in eng._pruners]}")
    # one likelihood per generation plus the initial score: one stacked
    # launch and one wavefront launch for each of divisions 4, 6 and 7
    calls = ngen + 1
    stacked = eng._stacked_pruners[0][1].launches
    wave = [p.launches for p in eng._pruners]
    expect = [calls if i in (4, 6, 7) else 0 for i in range(eng.n_div)]
    if stacked != calls or wave != expect:
        raise AssertionError(f"cynmix launches: stacked {stacked}, "
                             f"wavefront {wave}; predicted {calls} and "
                             f"{expect}")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    expect_rows = ngen // eng.mcmc.samplefreq + 1
    first = []
    for r in (1, 2):
        with open(os.path.join(workdir, f"cynmix.run{r}.p")) as f:
            rows = [ln.split("\t") for ln in f if ln[:1].isdigit()]
        with open(os.path.join(workdir, f"cynmix.run{r}.t")) as f:
            text = f.read()
        if len(rows) != expect_rows or not text.rstrip().endswith("end;") \
                or text.count("tree gen.") != expect_rows:
            raise AssertionError(f"cynmix.run{r}: {len(rows)} .p rows, "
                                 f"expected {expect_rows}, or incomplete .t")
        first.append(float(rows[0][1]))
    if not stats["best_lnl"] > max(first):
        raise AssertionError(f"cynmix best lnL {stats['best_lnl']} did not "
                             f"climb from the start {first}")
    log(f"cynmix through the CLI, wavefront and stacked on: "
        f"{json.dumps(stats)}; start lnL {first}; stacked launches "
        f"{stacked}, wavefront launches {wave} for {ngen} gens; card "
        f"{power_line}")
    return it, {**stats, "stacked_launches": stacked,
                "wavefront_launches": sum(wave)}


def phase_cynmix_switch(torch, it, blocks, power_line):
    """gens/s of the cynmix engine with the switches off and on (wavefront
    and stacked), in turns; then a block and one generation of each move
    type with host synchronisation made an error, switches on."""
    engines = {sw: it.build_engine(multiwalk=False, wavefront=sw, stacked=sw)
               for sw in (False, True)}
    runs = {}
    for sw, eng in engines.items():
        states, bk = eng.init_chains()
        runs[sw] = list(eng.run_block(states, bk, WARM_GENS))
    torch.cuda.synchronize()
    rates = {False: [], True: []}
    for b in range(blocks):
        for sw in ((False, True) if b % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            runs[sw] = list(engines[sw].run_block(*runs[sw], BLOCK_GENS))
            torch.cuda.synchronize()
            rates[sw].append(BLOCK_GENS / (time.perf_counter() - t0))
    out = {"off": float(np.median(rates[False])),
           "on": float(np.median(rates[True])),
           "off_blocks": rates[False], "on_blocks": rates[True]}
    log(f"cynmix switches off/on, {blocks} blocks of {BLOCK_GENS} gens each, "
        f"in turns: {json.dumps(out)}; card {power_line}")
    eng = engines[True]
    sync_checked(torch, eng, *runs[True], SYNC_GENS)
    log(f"cynmix, wavefront and stacked on: no host sync in a {SYNC_GENS}-gen "
        f"block or in any of the {len(eng.moves)} move types "
        f"({', '.join(m.name for m in eng.moves)})")
    return out


def shard_site_lnl(torch, root, ls, pi):
    """Per-pattern lnL [C, P] of one shard's root [C, K, S, P] and ls
    [C, P] under pi [S], with the engine's floor (padded patterns, whose
    root partials are 0, stay finite)."""
    from mrbayes_tpu_torch.ops.pruning import site_loglik_from_root
    pi = pi.to(root.device).expand(root.shape[0], -1)
    return site_loglik_from_root(root, ls, pi, 0.0, None)


def phase_sharded_kernels(torch, devices_for, shard_counts=SHARD_COUNTS):
    """``PruningCudaSharded`` at primates' shape (n_tips 12, P 413, S 4,
    K 4) at C = 4 and 32 over each shard count k (413 patterns pad to 414
    and 416 at k = 2 and 4), on ``devices_for(k)``: every shard against its
    plain version and against its slice of one unsharded pruning.cu
    launch; times of the k raw launches, of one, of the wrapper's call and
    of the plain version, beside the bound of the unsharded work with lr
    and the operators sent to each shard (``bound``)."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops.sharded_cuda import PruningCudaSharded
    from mrbayes_tpu_torch.parallel.mesh import _pad_to_multiple
    n_tips, P, S, K = 12, 413, 4, 4
    n_int = n_tips - 1
    worst, timing = 0.0, {}
    for C in (4, 32):
        rng = np.random.default_rng(400 + C)
        walk = random_walks(torch, rng, n_tips, C)
        tips, Pm, pi = random_operands(rng, n_tips, P, S, K, C)
        Pm, pi = (torch.as_tensor(x, device=DEV) for x in (Pm, pi))
        single = PC.PruningCuda(tips, K, torch.device(DEV))
        ref = site_lnl(torch, *single(*walk, Pm), pi)          # [C, P]
        for k in shard_counts:
            devs = devices_for(k)
            tp, pad = _pad_to_multiple(tips, 1, k)
            sh = PruningCudaSharded(tp, K, devs, DEV)
            outs = sh(*walk, Pm)
            torch.cuda.synchronize()
            if sh.launches != k:
                raise AssertionError(f"{sh.launches} launches for {k} "
                                     f"shards")
            lr, pstep = sh.operands(*walk, Pm)
            Pk = tp.shape[1] // k
            ops = []
            for j, ((r, l), t, dev) in enumerate(zip(outs, sh.tips,
                                                     sh.devices)):
                lr_d, pst_d = lr.to(dev), pstep.to(dev)
                a = shard_site_lnl(torch, r, l, pi)
                worst = max(worst, compare(
                    torch, a, shard_site_lnl(
                        torch, *PC.pruning_down_plain(lr_d, pst_d, t), pi),
                    f"sharded_down k={k} ({pad} padded) shard {j} on {dev} "
                    f"C={C} vs plain"))
                lo, hi = j * Pk, min((j + 1) * Pk, P)
                worst = max(worst, compare(
                    torch, a[:, :hi - lo].to(DEV), ref[:, lo:hi],
                    f"sharded_down k={k} shard {j} C={C} vs its slice of "
                    f"the unsharded pruning_down"))
                ops.append((lr_d, pst_d, t,
                            new_walk(torch, lr_d, pst_d, t)[0]))

            def raw(shards):
                for *_, fn in shards:
                    fn()

            def plain():
                for l_, p_, t_, *_ in ops:
                    PC.pruning_down_plain(l_, p_, t_)

            timing[(C, k)] = {
                "ms": time_events(torch, lambda: raw(ops), 300),
                "per_shard_ms": time_graph(torch, lambda: raw(ops[:1])),
                "per_shard_before_ms": time_graph(
                    torch, old_walk(torch, *ops[0][:3])),
                "walk": PC.pruning_plan(C, n_tips, K, S, Pk, devs[0]),
                "wrapper_ms": time_events(torch, lambda: sh(*walk, Pm),
                                          200),
                "plain_ms": time_events(torch, plain, 5),
                "padded_patterns": pad,
                **bound(4 * (k * (lr.numel() + pstep.numel())
                             + n_tips * S * P + C * K * S * P + C * P),
                        2 * C * n_int * 2 * K * S * S * P)}
            log(f"sharded_down timing primates C={C} k={k} on "
                f"{[str(d) for d in devs]}: {json.dumps(timing[(C, k)])}")
    return worst, timing


def phase_sharded_cynmix_kernels(torch, devices):
    """``PruningCudaSharded`` at every shape the sharded cynmix path gives
    it: the favored model's engine sharded over ``devices`` (the four
    genes, 537/125/203/330 patterns at S 4, and the morphology buckets of
    122/31/6/1 real patterns at S 2/3/4/8, padded to a multiple of the
    shard count, so that some shards hold padding only), each division's
    own sharded pruner on random trees of 32 tips and random operators at
    C = 8 and 32.  Every shard against the plain version on the same
    operands, and each coded division's dummy pass (``PruningCuda`` over
    [32, S, S]) against its plain version; the wrapper's time at C = 8."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    eng = cynmix_interpreter().build_engine()
    shard_engine_data(eng, make_mesh(1, len(devices), devices))
    worst, shapes = 0.0, {}
    for i, pr in enumerate(eng._pruners):
        n_tips, S, K = pr.n_tips, pr.S, pr.K
        Pk = pr.P // len(devices)
        real = eng.div_cfg[i].div.npat
        for C in (8, 32):
            rng = np.random.default_rng(500 + 10 * i + C)
            walk = random_walks(torch, rng, n_tips, C)
            Pm = rng.random((C, 2 * n_tips - 1, K, S, S)).astype(
                np.float32) + 0.05
            Pm = torch.as_tensor(Pm / Pm.sum(-1, keepdims=True), device=DEV)
            pi = rng.random(S).astype(np.float32) + 0.2
            pi = torch.as_tensor(pi / pi.sum(), device=DEV)
            lr, pstep = pr.operands(*walk, Pm)
            before = pr.launches
            outs = pr(*walk, Pm)
            if pr.launches - before != len(devices):
                raise AssertionError(f"division {i}: {pr.launches - before} "
                                     f"launches for {len(devices)} shards")
            for j, ((r, l), t, dev) in enumerate(zip(outs, pr.tips,
                                                     pr.devices)):
                held = max(0, min(Pk, real - j * Pk))     # real patterns
                worst = max(worst, compare(
                    torch, shard_site_lnl(torch, r, l, pi),
                    shard_site_lnl(torch, *PC.pruning_down_plain(
                        lr.to(dev), pstep.to(dev), t), pi),
                    f"sharded_down cynmix division {i} (S={S}, {real} "
                    f"patterns, {held} of {Pk} real) shard {j} C={C} vs "
                    f"plain"))
            if pr.dummy is not None:
                d_lr, d_pstep = pr.dummy.operands(*walk, Pm)
                worst = max(worst, compare(
                    torch, shard_site_lnl(torch, *pr.dummy(*walk, Pm), pi),
                    shard_site_lnl(torch, *PC.pruning_down_plain(
                        d_lr, d_pstep, pr.dummy.tips), pi),
                    f"cynmix division {i} dummy pass (n_tips={n_tips}, "
                    f"S={S}) C={C} vs plain"))
            if C == 8:
                shapes[f"div{i}"] = {
                    "S": S, "K": K, "patterns": real, "padded": pr.P,
                    "wrapper_ms": time_events(torch, lambda: pr(*walk, Pm),
                                              50)}
    log(f"sharded_down at the cynmix shapes over {len(devices)} shards: "
        f"{json.dumps(shapes)}")
    return worst, shapes


def phase_sharded_primates(torch, ds, devices, blocks, power_line):
    """Primates GTR+I+G, 1 run x 4 chains, over a sites mesh of
    ``devices``: lnL at identical states against the unsharded engine
    (5e-3), gens/s of the sharded and the unsharded engine in turns, the
    sharded pruner's launches over the sharded blocks (one per shard and
    generation), carried = recomputed, and no host sync in a block or in
    any move type."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS, Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    k = len(devices)
    engines = {sh: Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                          mcmc=McmcSettings(nruns=1, nchains=4, seed=3),
                          device=DEV) for sh in (False, True)}
    shard_engine_data(engines[True], make_mesh(1, k, devices))
    runs = {sh: list(eng.init_chains()) for sh, eng in engines.items()}
    st = {key: v for key, v in runs[True][0].items()
          if key not in SCORE_KEYS}
    diff = (engines[True].log_likelihood(st)
            - engines[False].log_likelihood(st)).abs().max().item()
    if diff > 5e-3:
        raise AssertionError(f"sharded lnL {diff} from the unsharded one")
    for sh, eng in engines.items():
        runs[sh] = list(eng.run_block(*runs[sh], WARM_GENS))
    torch.cuda.synchronize()
    pruner = engines[True]._pruners[0]
    pruner.launches = 0                     # the sharded run starts
    rates = {False: [], True: []}
    for b in range(blocks):
        for sh in ((True, False) if b % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            runs[sh] = list(engines[sh].run_block(*runs[sh], BLOCK_GENS))
            torch.cuda.synchronize()
            rates[sh].append(BLOCK_GENS / (time.perf_counter() - t0))
    launches = pruner.launches              # ... and ends here
    gens = blocks * BLOCK_GENS
    if launches != k * gens:
        raise AssertionError(f"{launches} sharded launches for {gens} "
                             f"generations over {k} shards")
    eng = engines[True]
    states, bk = sync_checked(torch, eng, *runs[True], SYNC_GENS)
    cold = assert_carried(eng, states, bk)
    out = {"shards": k, "devices": [str(d) for d in devices],
           "lnl_diff_identical_states": diff,
           "gens_per_s": float(np.median(rates[True])),
           "gens_per_s_unsharded": float(np.median(rates[False])),
           "gens_per_s_blocks": rates[True],
           "gens_per_s_unsharded_blocks": rates[False],
           "launches": launches, "gens": gens,
           "launches_per_gen": launches / gens,
           "cold_lnL": states["lnL"][cold].item()}
    log(f"primates GTR+I+G 4 chains over {k} site shards: "
        f"{json.dumps(out)}; no host sync in a {SYNC_GENS}-gen block or in "
        f"any of the {len(eng.moves)} move types; card {power_line}")
    return out


def phase_sharded_cynmix(torch, devices, power_line):
    """cynmix's favored model (2 runs x 4 chains) over a sites mesh of
    ``devices``: each division's lnL (float64 sums) against the unsharded
    engine (1e-3), gens/s of both in turns, the launches over the sharded
    blocks (shards x 8 divisions, plus one dummy pass for each of the four
    coded standard buckets, per generation), carried = recomputed, and no
    host sync in a block or in any move type."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    from mrbayes_tpu_torch.parallel.mesh import make_mesh, shard_engine_data
    k = len(devices)
    it = cynmix_interpreter()
    engines = {sh: it.build_engine() for sh in (False, True)}
    eng = engines[True]
    shard_engine_data(eng, make_mesh(1, k, devices))
    runs = {sh: list(e.init_chains()) for sh, e in engines.items()}
    st = {key: v for key, v in runs[True][0].items()
          if key not in SCORE_KEYS}
    diff = (eng.division_lnls(st)
            - engines[False].division_lnls(st)).abs().max().item()
    if diff > GOLDEN_PATH_TOL:
        raise AssertionError(f"sharded division lnL {diff} from the "
                             f"unsharded one")
    for sh, e in engines.items():
        runs[sh] = list(e.run_block(*runs[sh], WARM_GENS))
    torch.cuda.synchronize()
    dummies = [p.dummy for p in eng._pruners if p.dummy is not None]
    for p in eng._pruners + dummies:
        p.launches = 0                      # the sharded run starts
    gens_block = BLOCK_GENS // 2
    rates = {False: [], True: []}
    for b in range(2):
        for sh in ((True, False) if b % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            runs[sh] = list(engines[sh].run_block(*runs[sh], gens_block))
            torch.cuda.synchronize()
            rates[sh].append(gens_block / (time.perf_counter() - t0))
    launches = sum(p.launches for p in eng._pruners)
    dummy = sum(p.launches for p in dummies)   # ... and ends here
    gens = 2 * gens_block
    if launches != k * eng.n_div * gens or dummy != len(dummies) * gens \
            or len(dummies) != 4:
        raise AssertionError(f"cynmix sharded launches {launches}, dummy "
                             f"{dummy} for {gens} generations")
    states, bk = sync_checked(torch, eng, *runs[True], SYNC_GENS)
    assert_carried(eng, states, bk)
    out = {"shards": k, "max_division_lnl_diff": diff,
           "gens_per_s": float(np.median(rates[True])),
           "gens_per_s_unsharded": float(np.median(rates[False])),
           "gens_per_s_blocks": rates[True],
           "gens_per_s_unsharded_blocks": rates[False],
           "launches": launches, "dummy_launches": dummy, "gens": gens,
           "launches_per_gen": (launches + dummy) / gens}
    log(f"cynmix over {k} site shards: {json.dumps(out)}; no host sync in "
        f"a {SYNC_GENS}-gen block or in any of the {len(eng.moves)} move "
        f"types; card {power_line}")
    return out


def phase_sharded(torch, ds, count, power_line):
    """The sites mesh axis: the sharded launch against its plain version,
    primates and cynmix over 4 shards of the first card, the product-path
    dry run; over distinct cards too where the machine has them."""
    from mrbayes_tpu_torch.parallel.dryrun import dryrun_sites
    one_card = [f"{DEV}:0"] * 4
    err, timing = phase_sharded_kernels(torch, lambda k: one_card[:k])
    err_c, cyn_shapes = phase_sharded_cynmix_kernels(torch, one_card)
    err = max(err, err_c)
    prim = phase_sharded_primates(torch, ds, one_card, SHARD_BLOCKS,
                                  power_line)
    cyn = phase_sharded_cynmix(torch, one_card, power_line)
    dry = dryrun_sites(4, one_card, workdir=os.path.join(OUT, "dryrun"),
                       log=log)
    cards = {}
    if count >= 2:
        devs = [f"{DEV}:{i}" for i in range(min(count, 4))]
        e2, t2 = phase_sharded_kernels(torch, lambda k: devs[:k],
                                       (len(devs),))
        err = max(err, e2)
        cards = {"devices": devs,
                 "kernel": {f"c{C}": t for (C, _), t in t2.items()},
                 "primates": phase_sharded_primates(torch, ds, devs, 1,
                                                    power_line),
                 "dryrun": dryrun_sites(len(devs), devs, log=log)}
    else:
        log("sharded: one card, so every shard ran on cuda:0; times over "
            "distinct cards not measured")
    return err, timing, cyn_shapes, prim, cyn, dry, cards


def clock_walks(torch, rng, n_tips, C):
    """C seeded random clock trees on the card with IGR-spread branch
    lengths: (order, left, right, blen [C, n_nodes]).  Each chain's branch
    rates are lognormal with mean 1 and a variance drawn from [1, 10] and
    its clock rate log-uniform in [1, 100], so that lengths run from about
    1e-6 to tens of substitutions; blen[root] = 0 and the root is node
    2n-2."""
    from mrbayes_tpu_torch.mcmc.clock import clock_blens
    from mrbayes_tpu_torch.trees import random_clock_tree
    trees = [random_clock_tree(n_tips, rng, mean_age=0.1) for _ in range(C)]
    order, left, right = tree_walks(torch, [t for t, _ in trees])
    s2 = np.log1p(rng.uniform(1.0, 10.0, (C, 1)))
    state = {
        "parent": torch.as_tensor(np.stack([t.parent for t, _ in trees]),
                                  device=DEV).long(),
        "age": torch.as_tensor(np.stack([a for _, a in trees]),
                               dtype=torch.float32, device=DEV),
        "clockrate": torch.as_tensor(10.0 ** rng.uniform(0.0, 2.0, (C, 1)),
                                     dtype=torch.float32, device=DEV),
        "brate": torch.as_tensor(np.exp(rng.normal(
            -0.5 * s2, np.sqrt(s2), (C, 2 * n_tips - 1))),
            dtype=torch.float32, device=DEV)}
    return order, left, right, clock_blens(state, n_tips, "igr")


def clock_operators(torch, rng, blen, K):
    """Operators [C, n_nodes, K, S=4, S] of the branch lengths under a
    random GTR model a chain and gamma rates (shape 0.3-2), and the
    chains' stationary frequencies [C, 4]."""
    from mrbayes_tpu_torch.models.rates import GammaRateTable
    from mrbayes_tpu_torch.models.substitution import nuc_q_gtr
    from mrbayes_tpu_torch.ops.pruning import branch_tiprobs
    from mrbayes_tpu_torch.ops.tiprobs import eigh_reversible
    C = blen.shape[0]

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=DEV)

    pi = dev(rng.dirichlet(np.ones(4) * 5, C))
    lam, U, Uinv = eigh_reversible(
        nuc_q_gtr(dev(rng.dirichlet(np.ones(6) * 2, C)), pi), pi)
    rates = GammaRateTable(K, device=DEV)(dev(rng.uniform(0.3, 2.0, C)))
    return branch_tiprobs(blen, lam, U, Uinv, rates, 0.0), pi


def phase_clock_kernels(torch):
    """pruning.cu and multiwalk.cu on clock trees against their plain
    versions: test2's two division shapes (C = 8 and 32, K = 4, S = 4,
    P = 199 and 258) alone and as the multiwalk group, on seeded random
    clock trees with IGR-spread branch lengths (so P(t) runs from near the
    identity to near the stationary matrix and the per-pattern rescaling
    works at both ends), with the walk and block each took and its
    CUDA-graph time beside the bound."""
    from mrbayes_tpu_torch.ops import multiwalk_cuda as MW
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    n_tips, Ps, Ks, S = TEST1_SHAPE
    worst = {"pruning_down": 0.0, "multiwalk_down": 0.0}
    out = {"pruning_down": {}, "multiwalk_down": {}}
    for i, C in enumerate(CLOCK_CHAINS):
        rng = np.random.default_rng(700 + i)
        order, left, right, blen = clock_walks(torch, rng, n_tips, C)
        pos = blen[blen > 0]
        spread = {"blen_min": pos.min().item(), "blen_max": pos.max().item(),
                  "root_blen": blen[:, -1].abs().max().item()}
        specs, P_list, pis = [], [], []
        for P, K in zip(Ps, Ks):
            tips, _, _ = random_operands(rng, n_tips, P, S, K, 1)
            Pm, pi = clock_operators(torch, rng, blen, K)
            specs.append((tips, K))
            P_list.append(Pm)
            pis.append(pi)
            pruner = PC.PruningCuda(tips, K, torch.device(DEV))
            lr, pstep = pruner.operands(order, left, right, Pm)
            root_k, ls_k = PC.pruning_down(lr, pstep, pruner.tips)
            torch.cuda.synchronize()
            root_p, ls_p = PC.pruning_down_plain(lr, pstep, pruner.tips)
            raw, plan, root, ls = new_walk(torch, lr, pstep, pruner.tips)
            err = compare(
                torch, site_lnl(torch, root_k, ls_k, pi),
                site_lnl(torch, root_p, ls_p, pi),
                f"pruning_down clock tree n_tips={n_tips} P={P} S={S} K={K} "
                f"C={C} ({plan['walk']} walk, {plan['threads']} threads for "
                f"{plan['T']} patterns, {plan['lanes']} lanes a pattern; "
                f"branch lengths {spread['blen_min']:.2e}.."
                f"{spread['blen_max']:.2e}, log-scales "
                f"{ls_k.min().item():.1f}..{ls_k.max().item():.1f})")
            worst["pruning_down"] = max(worst["pruning_down"], err)
            flops = 2 * C * (n_tips - 1) * 2 * K * S * S * P
            nbytes = 4 * (lr.numel() + pstep.numel() + pruner.tips.numel()
                          + root.numel() + ls.numel())
            out["pruning_down"][f"P{P}_C{C}"] = {
                **{k: plan[k] for k in ("walk", "threads", "T", "lanes")},
                "max_abs_err": err, "ms": time_graph(torch, raw),
                **spread, **{k: v for k, v in bound(nbytes, flops).items()
                             if k in ("bound_ms", "bound_by")}}
            log(f"pruning_down clock timing P={P} C={C}: "
                f"{json.dumps(out['pruning_down'][f'P{P}_C{C}'])}")
        group = MW.PruningCudaMultiwalk(specs, torch.device(DEV))
        lay = group.layout
        lr, pstep = group.operands(order, left, right, P_list)
        root_k, ls_k = MW.multiwalk_down(lr, pstep, group.tips, lay)
        torch.cuda.synchronize()
        root_p, ls_p = MW.multiwalk_down_plain(lr, pstep, group.tips, lay)
        plan = lay.plan(C, lr.device)
        errs = [compare(
            torch, site_lnl(torch, *lay.div_view(root_k, ls_k, d), pis[d]),
            site_lnl(torch, *lay.div_view(root_p, ls_p, d), pis[d]),
            f"multiwalk_down clock tree n_tips={n_tips} P={Ps} K={Ks} S={S} "
            f"C={C} division {d} ({plan['walks'][d]} walk, "
            f"{plan['threads']} threads for {plan['T'][d]} patterns, "
            f"{plan['lanes'][d]} lanes a pattern)") for d in range(lay.D)]
        worst["multiwalk_down"] = max([worst["multiwalk_down"]] + errs)
        raw, _, root, ls = group_walk(torch, lay, lr, pstep, group.tips)
        flops = sum(2 * C * (n_tips - 1) * 2 * K * S * S * P
                    for K, P in zip(lay.ks, lay.ps))
        out["multiwalk_down"][f"C{C}"] = {
            **{k: plan[k] for k in ("walks", "threads", "T", "lanes")},
            "max_abs_err": max(errs), "ms": time_graph(torch, raw),
            **{k: v for k, v in bound(
                4 * (lr.numel() + pstep.numel() + group.tips.numel()
                     + root.numel() + ls.numel() + plan["tiles"].numel())
                + 8 * plan["table"].numel(), flops).items()
               if k in ("bound_ms", "bound_by")}}
        log(f"multiwalk_down clock timing test2 C={C}: "
            f"{json.dumps(out['multiwalk_down'][f'C{C}'])}")
    return worst, out


def phase_golden_clock(torch, ds):
    """The clock_uniform_gtr_g rows of tests/golden_primates.json on the
    card: lnL within 0.2 and lnPrior within 0.01 of the reference
    (tests/test_clock.py:37-53).  Returns the worst gaps and the
    pruning.cu launches they made."""
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings, TreeSettings)
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN))
            if r["model"] == "clock_uniform_gtr_g"]
    eng = Engine(ds, [DivisionSettings(nst="6", rates="gamma")],
                 tree_settings=TreeSettings(clock=True, clockpr="uniform"),
                 mcmc=McmcSettings(nruns=1, nchains=1), device=DEV)
    worst = [0.0, 0.0]
    for rec in rows:
        t = parse_newick(rec["newick"], ds.taxa, rooted=True)
        ages = np.zeros(t.n_nodes)
        for v in t.postorder():
            ages[v] = max(ages[t.left[v]] + t.blen[t.left[v]],
                          ages[t.right[v]] + t.blen[t.right[v]])
        st = {k: torch.as_tensor(np.asarray(getattr(t, k))[None],
                                 device=DEV).long()
              for k in ("left", "right", "parent")}
        st["age"] = torch.tensor(ages[None], dtype=torch.float32, device=DEV)
        for k, f in (("pi", "pi"), ("revmat", "revmat")):
            st[k] = torch.tensor([[rec[f]]], dtype=torch.float32, device=DEV)
        st["shape"] = torch.tensor([[rec["alpha"]]], device=DEV)
        st = eng.refresh_eigs(st)
        lnl = eng.log_likelihood(st)[0].item()
        lnp = eng.log_prior(st)[0].item()
        worst = [max(worst[0], abs(lnl - rec["lnL"])),
                 max(worst[1], abs(lnp - rec["lnPrior"]))]
        if abs(lnl - rec["lnL"]) >= 0.2 or abs(lnp - rec["lnPrior"]) >= 0.01:
            raise AssertionError(
                f"golden clock_uniform_gtr_g: lnL {lnl} / lnPrior {lnp} vs "
                f"reference {rec['lnL']} / {rec['lnPrior']}")
    launches = eng._pruners[0].launches
    if launches < len(rows):
        raise AssertionError(f"{launches} pruning_down launches for "
                             f"{len(rows)} golden clock rows")
    log(f"golden clock_uniform_gtr_g: {len(rows)} rows, max |lnL - "
        f"reference| {worst[0]:.4f} (limit 0.2), max |lnPrior - reference| "
        f"{worst[1]:.5f} (limit 0.01), {launches} pruning_down launches")
    return worst, launches


def clock_tree_stats(left, right, parent, age, n_tips):
    """Statistics of rooted clock trees in the port's layout (root at
    node 2n-2), over the leading axes of [..., 2n-1] arrays: the
    second-oldest and the mean non-root internal age over the root age,
    the number of cherries and the tip count of the smaller root clade."""
    n, root = n_tips, 2 * n_tips - 2
    inner = age[..., n:root] / age[..., root:root + 1]
    cur = np.broadcast_to(np.arange(n), age.shape[:-1] + (n,)).copy()
    for _ in range(n - 1):                  # climb to the root's child
        p = np.take_along_axis(parent, cur, -1)
        cur = np.where(p == root, cur, p)
    size = (cur == left[..., root:root + 1]).sum(-1)
    return {"age2_over_root": inner.max(-1),
            "mean_age_over_root": inner.mean(-1),
            "cherries": ((left[..., n:] < n)
                         & (right[..., n:] < n)).sum(-1).astype(float),
            "root_minor_clade": np.minimum(size, n - size).astype(float)}


def uniform_clock_draws(n_tips, draws, rng):
    """Direct draws of the uniform clock prior given the root age (the
    density (n-1) log 2 - log n! - log(n-1) - (n-2) log t1 of reference
    src/mcmc.c:9494): the n - 2 non-root internal ages iid uniform below
    the root (age 1), the ranked topology uniform, i.e. each internal
    node, youngest first, joins a uniform pair of the lineages then
    present.  Returns left, right, parent, age as [draws, 2n-1] arrays."""
    n, nn = n_tips, 2 * n_tips - 1
    left = np.full((draws, nn), -1)
    right = np.full((draws, nn), -1)
    parent = np.full((draws, nn), -1)
    age = np.zeros((draws, nn))
    age[:, n:nn - 1] = np.sort(rng.uniform(size=(draws, n - 2)), -1)
    age[:, nn - 1] = 1.0
    active = np.tile(np.arange(n), (draws, 1))   # first k columns live
    rows = np.arange(draws)
    for i in range(n - 1):
        k, node = n - i, n + i
        a = rng.integers(0, k, draws)
        b = rng.integers(0, k - 1, draws)
        b = b + (b >= a)
        na, nb = active[rows, a], active[rows, b]
        left[:, node], right[:, node] = na, nb
        parent[rows, na] = parent[rows, nb] = node
        # the new node takes column a, the last live column fills b
        active[rows, a] = node
        active[rows, b] = np.where(b == k - 1, active[rows, b],
                                   active[rows, k - 1])
    return left, right, parent, age


def phase_prior_only(torch, ds, seed, power_line):
    """mcmc data=no on a uniform clock with IGR rates and clockratepr=
    exp(1), PRIOR_RUNS runs x 1 chain from ``seed``: over the second half
    of PRIOR_GENS generations, the mean root age (treeagepr gamma(1, 1):
    the uniform clock's root age has exactly that marginal), the mean
    clock rate and the mean branch rate must each lie within 4 batch-means
    standard errors (one batch a run) of 1, and each of clock_tree_stats'
    means within 4 standard errors (the runs' and the direct sample's
    together) of its mean over PRIOR_DRAWS direct draws of the prior.
    This holds the clock moves' Hastings ratios on the ages and on the
    topology."""
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings, Prior,
                                                 TreeSettings)
    eng = Engine(ds, [DivisionSettings(nst="1")],
                 tree_settings=TreeSettings(
                     clock=True, clockvarpr="igr",
                     clockratepr=Prior("exponential", (1.0,))),
                 mcmc=McmcSettings(nruns=PRIOR_RUNS, nchains=1, seed=seed,
                                   use_data=False), device=DEV)
    states, bk = eng.init_chains()
    n, root = eng.n_tips, eng.n_nodes - 1
    rec, trees = [], []
    t0 = time.perf_counter()
    for _ in range(PRIOR_GENS // 10):
        states, bk = eng.run_block(states, bk, 10)
        rec.append(torch.stack([states["age"][:, root],
                                states["clockrate"][:, 0],
                                states["brate"][:, :root].mean(1)], 1))
        trees.append((torch.stack([states[k] for k in (
            "left", "right", "parent")]), states["age"].clone()))
    x = torch.stack(rec).cpu().numpy()                   # [recs, runs, 3]
    rate = PRIOR_GENS / (time.perf_counter() - t0)
    half = x.shape[0] // 2
    topo = torch.stack([t for t, _ in trees[half:]]).cpu().numpy()
    ages = torch.stack([a for _, a in trees[half:]]).double().cpu().numpy()
    stats = clock_tree_stats(topo[:, 0], topo[:, 1], topo[:, 2], ages, n)
    direct = clock_tree_stats(*uniform_clock_draws(
        n, PRIOR_DRAWS, np.random.default_rng(seed)), n)
    out = {"seed": seed, "gens": PRIOR_GENS, "runs": PRIOR_RUNS,
           "gens_per_s": rate}
    bad = []

    def hold(nm, means, target, target_se):
        mu = float(means.mean())
        se = float(np.hypot(means.std(ddof=1) / np.sqrt(PRIOR_RUNS),
                            target_se))
        out[nm] = {"mean": mu, "prior": target, "se": se,
                   "z": (mu - target) / se}
        if abs(mu - target) > 4.0 * se:
            bad.append(nm)

    for i, nm in enumerate(("root_age", "clockrate", "brate")):
        hold(nm, x[half:, :, i].mean(0), 1.0, 0.0)
    for nm, v in stats.items():
        d = direct[nm]
        hold(nm, v.mean(0), float(d.mean()),
             float(d.std(ddof=1) / np.sqrt(PRIOR_DRAWS)))
    log(f"prior-only clock (data=no, uniform, IGR, clockratepr=exp(1)), "
        f"seed {seed}, {PRIOR_RUNS} runs x 1 chain, {PRIOR_GENS} gens: "
        f"{json.dumps(out)}; card {power_line}")
    if bad:
        raise AssertionError(f"prior-only marginals off their prior means "
                             f"(seed {seed}): {bad}")
    return out


def reversible_batch(torch, rng, B, S):
    """B seeded symmetrised reversible generators [B, S, S] (float64, on
    the card; ``eigh_bench.reversible_batch``: every fourth Poisson's)."""
    from mrbayes_tpu_torch.eigh_bench import reversible_batch as batch
    return torch.tensor(batch(rng, B, S), dtype=torch.float64, device=DEV)


def eigh_flops(S):
    """Float64 operations of one symmetric S x S eigendecomposition with
    eigenvectors, whatever the method: about 9 S^3 (the symmetric QR
    algorithm's count, Golub and Van Loan 8.3), not the Jacobi sweeps
    eigh.cu takes."""
    return 9 * S ** 3


def p_of_t(torch, w, V, t):
    return V @ torch.diag_embed(torch.exp(w * t)) @ V.transpose(-1, -2)


def eigh_case(torch, E, A):
    """One batch through eigh.cu, its plain version and its first design:
    the gates' numbers and the times."""
    B, S = A.shape[0], A.shape[1]
    w, V, sw = E.eigh_cuda(A, with_sweeps=True)
    wb, Vb = torch.empty_like(w), torch.empty_like(V)
    swb = torch.empty_like(sw)
    if E.eigh_launch(A, wb, Vb, swb, before=True) != 0:
        raise AssertionError(f"eigh first design B={B} S={S}: refused")
    torch.cuda.synchronize()
    wp, Vp = E.eigh_plain(A)
    rec = ((V @ torch.diag_embed(w) @ V.transpose(-1, -2) - A).norm(
        dim=(1, 2)) / A.norm(dim=(1, 2))).max().item()
    p_err = p_before = 0.0
    for t in (0.01, 0.1, 1.0, 10.0):
        P = p_of_t(torch, w, V, t)
        p_err = max(p_err, (P - p_of_t(torch, wp, Vp, t)).abs().max().item())
        p_before = max(p_before,
                       (P - p_of_t(torch, wb, Vb, t)).abs().max().item())
    sweeps, before = sw.cpu().numpy(), swb.cpu().numpy()
    d_sweeps = int(np.abs(sweeps - before).max())
    log(f"eigh_cuda B={B} S={S}: |A - V diag(w) V^T| / |A| {rec:.3e}, "
        f"max |P(t) - plain| {p_err:.3e} (limit {EIGH_TOL}), sweeps "
        f"{int(sweeps.min())}-{int(sweeps.max())}; first design: sweeps "
        f"{int(before.min())}-{int(before.max())} (most apart {d_sweeps}), "
        f"max |P(t) - first design's| {p_before:.3e}")
    if not (rec <= EIGH_TOL and p_err <= EIGH_TOL and d_sweeps <= 1
            and p_before <= EIGH_TOL):
        raise AssertionError(f"eigh_cuda B={B} S={S} disagrees with its "
                             f"plain version or its first design")
    w_o, V_o = torch.empty_like(w), torch.empty_like(V)
    nbytes = 8 * (A.numel() + w.numel() + V.numel())
    return {
        "max_abs_err": p_err, "reconstruction": rec,
        "max_abs_diff_before": p_before,
        "sweeps_min": int(sweeps.min()), "sweeps_max": int(sweeps.max()),
        "sweeps_mean": float(sweeps.mean()),
        "before_sweeps_mean": float(before.mean()),
        "sweeps_most_apart": d_sweeps,
        "ms": time_graph(torch, lambda: E.eigh_launch(A, w_o, V_o, None),
                         n=20, reps=3),
        "before_ms": time_graph(
            torch, lambda: E.eigh_launch(A, w_o, V_o, None, before=True),
            n=20, reps=3),
        "wrapper_ms": time_events(torch, lambda: E.eigh_cuda(A), 20),
        "plain_ms": time_events(torch, lambda: E.eigh_plain(A), 5),
        "library_ms": time_events(torch, lambda: torch.linalg.eigh(A), 5),
        **{k: v for k, v in bound(nbytes, B * eigh_flops(S),
                                  H100_FP64_FLOPS).items()
           if k in ("bound_ms", "bound_by")},
        "plan": E.device_plan(S)}


def phase_eigh(torch):
    """eigh.cu against its plain version (torch.linalg.eigh in float64) and
    its kept first design at the batches the main path gives it and at
    runtime S, seeded reversible generators with Poisson's among them:
    A = V diag(w) V^T within EIGH_TOL of |A|, P(t) within EIGH_TOL of the
    plain version's and of the first design's at four branch lengths, and
    sweeps within one of the first design's on every matrix; the sweeps
    taken, the kernel's and the first design's CUDA-graph times, the plain
    version's and torch.linalg.eigh's (library_ms) on the same batch, the
    bound, and each instantiation's plan (held equal to its twin
    ``eigh_plan``)."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    for S in range(E.MIN_S, E.MAX_S + 1):
        if E.device_plan(S) != E.eigh_plan(S):
            raise AssertionError(f"mb_eigh_plan({S}) {E.device_plan(S)} is "
                                 f"not its twin's {E.eigh_plan(S)}")
    rng = np.random.default_rng(300)
    cases = {}
    for B, S in EIGH_CASES:
        cases[f"B{B}_S{S}"] = eigh_case(torch, E,
                                        reversible_batch(torch, rng, B, S))
    rng = np.random.default_rng(301)
    for B, S in EIGH_RUNTIME_CASES:
        cases[f"B{B}_S{S}"] = eigh_case(torch, E,
                                        reversible_batch(torch, rng, B, S))
    for key, case in cases.items():
        log(f"eigh_cuda timing {key}: {json.dumps(case)}")
    return cases


def aa_codon_engine(torch, data, lines, nruns=1, nchains=1, seed=3):
    """The port's engine for ``data`` (an examples file) under the CLI
    ``lines``, on the card."""
    from mrbayes_tpu_torch.cli import Interpreter
    it = Interpreter(log=lambda m: None, device=DEV)
    for ln in [f"execute {data}", *lines,
               f"mcmcp nruns={nruns} nchains={nchains} seed={seed}"]:
        it.run_line(ln)
    return it, it.build_engine()


def phase_golden_aa_codon(torch):
    """The protein_jones_g and codon_m0 rows of tests/golden_primates.json
    and the replicase_ny98 rows of tests/golden_extra.json on the card,
    at the CPU tests' tolerances (0.05, 0.6 and each row's tol).  Returns
    the worst gap of each and the pruning.cu and eigh.cu launches they
    made."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    from mrbayes_tpu_torch.trees import parse_newick
    gold = json.load(open(GOLDEN))
    sets = [("protein_jones_g", AVIAN, ["lset rates=gamma",
                                        "prset aamodelpr=fixed(jones)"],
             [r for r in gold if r["model"] == "protein_jones_g"]),
            ("codon_m0", REPLICASE, ["lset nucmodel=codon"],
             [r for r in gold if r["model"] == "codon_m0"]),
            ("replicase_ny98", REPLICASE,
             ["lset nucmodel=codon omegavar=ny98"],
             [r for r in json.load(open(GOLDEN_EXTRA))
              if r["name"] == "replicase_ny98"])]
    tol = {"protein_jones_g": 0.05, "codon_m0": 0.6}
    out, launches = {}, {"pruning_down": 0, "eigh": 0}
    E.EIGH.launches = 0
    for name, data, lines, rows in sets:
        _, eng = aa_codon_engine(torch, data, lines)
        worst = 0.0
        for rec in rows:
            st = tree_state(torch, parse_newick(rec["newick"], eng.data.taxa))
            state = rec.get("state", {
                "shape": [rec["alpha"]] if "alpha" in rec else None,
                "pi61": [rec["pi61"]] if "pi61" in rec else None,
                "omega": [rec["omega"]] if "omega" in rec else None})
            for k, v in state.items():
                if v is not None:
                    st[k] = torch.tensor([v], dtype=torch.float32,
                                         device=DEV)
            lnl = eng.log_likelihood(eng.refresh_eigs(st))[0].item()
            worst = max(worst, abs(lnl - rec["lnL"]))
            if abs(lnl - rec["lnL"]) >= tol.get(name, rec.get("tol")):
                raise AssertionError(f"golden {name}@{rec.get('gen')}: lnL "
                                     f"{lnl} vs reference {rec['lnL']}")
        out[name] = worst
        launches["pruning_down"] += eng._pruners[0].launches
        log(f"golden {name}: {len(rows)} rows, max |lnL - reference| "
            f"{worst:.4f} (limit {tol.get(name, rows[0].get('tol'))}), "
            f"{eng._pruners[0].launches} pruning_down launches")
    launches["eigh"] = E.EIGH.launches
    if launches["eigh"] < len(sets[1][3]) + len(sets[2][3]):
        raise AssertionError(f"{launches['eigh']} eigh_cuda launches for "
                             f"the codon rows")
    return out, launches


def solver_q_generations(eng, bk):
    """Generations of the run in ``bk`` that changed a Q matrix, plus the
    initial refresh: the eigh.cu launches predicted for an engine whose
    eigensystems go through the solver (one launch a refresh: every
    chain's and class's matrices in one batch)."""
    tries = bk["tries_total"][0].cpu().numpy()
    return 1 + int(sum(tries[m] for m, spec in enumerate(eng.moves)
                       if spec.updates_q))


def build_eigh_launches(eng):
    """The eigh.cu launches of an engine's build: one per division whose
    fixed eigensystem has more than 8 states, and one for the stack of
    aamodelpr=mixed's 11 models."""
    return (sum(1 for i in eng._const_eigs if eng.div_cfg[i].div.n_states > 8)
            + (1 if eng.n_groups.get("aamodel") else 0))


def phase_aa_codon_cli(torch, name, ngen, solver, power_line):
    """avian (aamodelpr=mixed) or replicase under NY98 through the CLI, 2
    runs x 4 chains: one pruning.cu launch per likelihood (ngen + 1: no
    division groups), eigh.cu once per fixed eigensystem at the engine's
    build (``build_eigh_launches``) and once per refresh where the
    division's Q goes through the solver (``solver``),
    carried versus recomputed scores, complete files, sump and sumt; for
    avian the posterior share of each amino-acid model.  The engine is
    built inside ``execute_file``: its counts start at 0 there, eigh.cu's
    is set to 0 just before, and both are read when the run is over."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.mcmc.engine import AA_MIXED_ORDER
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    from mrbayes_tpu_torch.ops.pruning_cuda import PruningCuda
    workdir = os.path.join(OUT, name)
    shutil.rmtree(workdir, ignore_errors=True)
    E.EIGH.launches = 0                       # the main path's run starts
    it, stats, lines = run_batch(name, workdir, ngen, device=DEV,
                                 diagnfreq=min(1000, ngen))
    eigh_launches = E.EIGH.launches           # ... and ends here
    runner = it._last_runner
    eng = runner.eng
    if eng._multiwalk_pruners or eng._stacked_pruners \
            or type(eng._pruners[0]) is not PruningCuda:
        raise AssertionError(f"{name}: expected one pruning.cu division")
    calls = ngen + 1
    launches = eng._pruners[0].launches
    expect_eigh = build_eigh_launches(eng) + (
        solver_q_generations(eng, runner.final_bk) if solver else 0)
    if launches != calls or eigh_launches != expect_eigh:
        raise AssertionError(f"{name} launches: pruning_down {launches}, "
                             f"eigh {eigh_launches}; predicted {calls} and "
                             f"{expect_eigh}")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    expect_rows = ngen // eng.mcmc.samplefreq + 1
    first, idx = [], []
    for r in (1, 2):
        with open(os.path.join(workdir, f"{name}.run{r}.p")) as f:
            f.readline()
            header = f.readline().rstrip("\n").split("\t")
            rows = [ln.split("\t") for ln in f if ln[:1].isdigit()]
        with open(os.path.join(workdir, f"{name}.run{r}.t")) as f:
            text = f.read()
        if len(rows) != expect_rows or not text.rstrip().endswith("end;") \
                or text.count("tree gen.") != expect_rows:
            raise AssertionError(f"{name}.run{r}: {len(rows)} .p rows, "
                                 f"expected {expect_rows}, or incomplete .t")
        first.append(float(rows[0][1]))
        if "aamodel" in header:
            col = header.index("aamodel")
            idx += [int(float(x[col])) for x in rows[len(rows) // 4:]]
    if not stats["best_lnl"] > max(first):
        raise AssertionError(f"{name} best lnL {stats['best_lnl']} did not "
                             f"climb from the start {first}")
    shares = ({m: idx.count(k) / len(idx)
               for k, m in enumerate(AA_MIXED_ORDER)} if idx else None)
    log(f"{name} through the CLI: {json.dumps(stats)}; start lnL {first}; "
        f"pruning_down launches {launches}, eigh launches {eigh_launches} for "
        f"{ngen} gens; posterior model shares {json.dumps(shares)}; card "
        f"{power_line}")
    return it, {**stats, "pruning_down_launches": launches,
                "eigh_launches": eigh_launches, "aamodel_shares": shares}


def phase_aa_codon_sync(torch, name, eng, power_line, solver=True):
    """A block and one generation of every move type of ``eng`` with host
    synchronisation made an error, and eigh.cu's launches over them
    against the prediction: one a Q-move generation and division whose Q
    goes through the solver (``solver``: True or the number of such
    divisions), none where none does."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    states, bk = eng.init_chains()
    torch.cuda.synchronize()
    before = bk["tries_total"][0].clone()
    E.EIGH.launches = 0
    states, bk = sync_checked(torch, eng, states, bk, SYNC_GENS)
    launches = E.EIGH.launches
    q = [m for m, spec in enumerate(eng.moves) if spec.updates_q]
    expect = int(solver) * (int((bk["tries_total"][0] - before)[q].sum())
                            + len(q))
    if launches != expect:
        raise AssertionError(f"{name}: {launches} eigh launches, predicted "
                             f"{expect}")
    log(f"{name}: no host sync in a {SYNC_GENS}-gen block or in any of the "
        f"{len(eng.moves)} move types ({', '.join(m.name for m in eng.moves)})"
        f"; eigh launches {launches} ({len(q)} Q move types); card "
        f"{power_line}")
    return launches


def prior_start(torch, eng, states, rng):
    """The chains' amino-acid model and codon parameters drawn from the
    prior the engine samples (the moves' bounds included), so that a
    prior-only run is at its target from the first generation and needs
    no burn-in: the model index uniform, omega/(1+omega) uniform on the
    omega multiplier's [1e-4, 1e3], omega1 uniform, omega3 1 + Exp(1), the
    class and codon frequencies flat Dirichlet.  Returns rescored
    states."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    n = states["parent"].shape[0]
    lo, hi = 1e-4 / (1 + 1e-4), 1e3 / (1 + 1e3)
    draws = {"aamodel_idx": lambda: rng.integers(0, 11, (n, 1)),
             "omega": lambda: (lambda x: x / (1 - x))(
                 rng.uniform(lo, hi, (n, 1))),
             "omega1": lambda: rng.uniform(size=(n, 1)),
             "omega3": lambda: 1.0 + rng.exponential(size=(n, 1)),
             "omegaprobs": lambda: rng.dirichlet(np.ones(3), (n, 1)),
             "pi61": lambda: rng.dirichlet(np.ones(61), (n, 1))}
    st = {k: v for k, v in states.items() if k not in SCORE_KEYS}
    for k, draw in draws.items():
        if k in st:
            st[k] = torch.as_tensor(draw(), dtype=st[k].dtype,
                                    device=DEV).reshape(st[k].shape)
    return eng.score(eng.refresh_eigs(st))


def phase_aa_codon_prior(torch, seed, power_line):
    """mcmc data=no, AA_PRIOR_RUNS runs x 1 chain from ``seed``, each run
    started from a draw of the prior (``prior_start``), over AA_PRIOR_GENS
    generations: avian under aamodelpr=mixed, each model's share within 4
    batch-means standard errors (one batch a run) of 1/11; replicase under
    M0, omega/(1+omega) (Beta(1,1) under omegapr=dirichlet(1,1), on the
    multiplier's bounds: mean 0.49955) within 4 of its mean; under NY98,
    omega1 (Beta(1,1)) within 4 of 1/2, omega3 (exponential(1) on the
    move's [1, 1000]) within 4 of 2 and each class frequency (Dirichlet(1,
    1,1)) within 4 of 1/3.  A wrong Hastings ratio of aamodel_jump or of
    an omega move drifts the runs off these means."""
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings, Prior)
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.parser import read_nexus_file

    def dataset(path):
        nf = read_nexus_file(path)
        return DataSet(taxa=nf.taxa, nchar=nf.matrix.nchar,
                       divisions=make_divisions(nf.matrix))

    def stats_mixed(st):
        idx = st["aamodel_idx"][:, 0]
        return torch.stack([(idx == k).float() for k in range(11)], 1)

    def stats_m0(st):
        w = st["omega"][:, 0]
        return (w / (1.0 + w))[:, None]

    def stats_ny98(st):
        return torch.cat([st["omega1"], st["omega3"],
                          st["omegaprobs"][:, 0]], 1)

    runs = [("avian mixed", AVIAN, DivisionSettings(
                aamodelpr=Prior("mixed", ())), stats_mixed,
             [(f"share({m})", 1.0 / 11) for m in range(11)]),
            ("replicase M0", REPLICASE, DivisionSettings(nucmodel="codon"),
             stats_m0, [("omega/(1+omega)",
                         0.5 * (1e-4 / (1 + 1e-4) + 1e3 / (1 + 1e3)))]),
            ("replicase NY98", REPLICASE, DivisionSettings(
                nucmodel="codon", omegavar="ny98"), stats_ny98,
             [("omega1", 0.5), ("omega3", 2.0), ("pi(-)", 1.0 / 3),
              ("pi(N)", 1.0 / 3), ("pi(+)", 1.0 / 3)])]
    out, bad = {"seed": seed, "gens": AA_PRIOR_GENS,
                "runs": AA_PRIOR_RUNS}, []
    rng = np.random.default_rng(seed)
    for what, data, setts, fn, targets in runs:
        eng = Engine(dataset(data), [setts], mcmc=McmcSettings(
            nruns=AA_PRIOR_RUNS, nchains=1, seed=seed, use_data=False),
            device=DEV)
        states, bk = eng.init_chains()
        states = prior_start(torch, eng, states, rng)
        rec = []
        t0 = time.perf_counter()
        for _ in range(AA_PRIOR_GENS // 10):
            states, bk = eng.run_block(states, bk, 10)
            rec.append(fn(states))
        x = torch.stack(rec).cpu().numpy()            # [recs, runs, stats]
        rate = AA_PRIOR_GENS / (time.perf_counter() - t0)
        means = x.mean(0)                             # [runs, stats]
        res = {"gens_per_s": rate}
        for j, (nm, target) in enumerate(targets):
            mu = float(means[:, j].mean())
            se = float(means[:, j].std(ddof=1) / np.sqrt(AA_PRIOR_RUNS))
            z = (mu - target) / se if se > 0 else float("inf")
            res[nm] = {"mean": mu, "prior": target, "se": se, "z": z}
            if not abs(z) <= 4.0:
                bad.append(f"{what} {nm}")
        out[what] = res
    log(f"prior-only amino-acid and codon models (data=no), seed {seed}, "
        f"{AA_PRIOR_RUNS} runs x 1 chain, {AA_PRIOR_GENS} gens: "
        f"{json.dumps(out)}; card {power_line}")
    if bad:
        raise AssertionError(f"prior-only marginals off their prior means "
                             f"(seed {seed}): {bad}")
    return out


# ---------------------------------------------------------------------------
# hymfossil: total-evidence dating under the fossilized birth-death prior


def hymfossil_interpreter(**switches):
    """hymfossil.nex's FBD analysis (envelope.BATCHES["hymfossil"], the
    hymfossil_fbd_totev rows' commands) in a CLI interpreter on the card,
    2 runs x 4 chains, the kernel-path switches as given (off unless
    named)."""
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.envelope import BATCHES
    data, model = BATCHES["hymfossil"]
    it = Interpreter(log=lambda m: None, device=DEV,
                     **{"multiwalk": False, "wavefront": False,
                        "stacked": False, **switches})
    for line in (f"execute {data}", *model, "mcmcp nruns=2 nchains=4 seed=5"):
        it.run_line(line)
    return it


def hymfossil_kernel_states(torch, eng, C, rng):
    """C chain states of the hymfossil engine on the card, on the
    reference's own sampled trees: the three hymfossil_fbd_totev rows'
    trees and ages in turn (extant tips aged about 1e-8; at generations 30
    and 60 fossils on zero-length branches, sampled ancestors, flagged in
    ``sa``), their clock rate and rate multipliers, and seeded gamma
    shapes, exchangeabilities and frequencies."""
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] == "hymfossil_fbd_totev"]
    base = [hymfossil_row_state(torch, r, eng.data.taxa) for r in rows]
    st = {k: torch.cat([base[c % len(base)][k] for c in range(C)])
          for k in base[0]}
    n = eng.n_tips
    fossil = torch.as_tensor(eng.fossil_tips, device=DEV)
    st["sa"] = ((eng.branch_lengths(st)[:, :n] == 0) & fossil).long()
    g = eng.n_groups
    for k, a in (("revmat", 2.0), ("pi", 5.0)):
        st[k] = torch.as_tensor(rng.dirichlet(
            np.full(st[k].shape[-1], a), (C, g[k])), dtype=torch.float32,
            device=DEV)
    st["shape"] = torch.as_tensor(rng.uniform(0.5, 2.0, (C, g["shape"])),
                                  dtype=torch.float32, device=DEV)
    return eng.refresh_eigs(st)


def phase_hymfossil_kernels(torch):
    """pruning.cu against its plain version at every hymfossil division's
    shape (114 tips; P with the coding dummies; S 2-7 and 4; K 4) at
    C = 8 and 32, on the engine's own operands for the reference's dated
    trees with sampled ancestors on zero-length branches
    (``hymfossil_kernel_states``): the walk the size rule took, the
    CUDA-graph time beside the old walk's (before_ms), the plain
    version's and the bound."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops.pruning import branch_tiprobs
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    eng = hymfossil_interpreter().build_engine()
    worst, cases = 0.0, {}
    for C in HYM_CHAINS:
        rng = np.random.default_rng(900 + C)
        st = hymfossil_kernel_states(torch, eng, C, rng)
        blen = eng.branch_lengths(st)
        n = eng.n_tips
        zero = blen[:, :n] == 0
        if not zero.any() or (zero != (st["sa"] > 0)).any():
            raise AssertionError("hymfossil kernel trees: the zero-length "
                                 "branches must be the sampled ancestors'")
        order = postorder_internal(st["parent"], n)
        for i, pruner in enumerate(eng._pruners):
            pi, _, lam, U, Uinv, rates, pinv, cmask, mult = \
                eng._generic_div_params(st, i)
            Pm = branch_tiprobs(blen, lam, U, Uinv, rates,
                                pinv if cmask is not None else 0.0, mult)
            lr, pstep = pruner.operands(order, st["left"], st["right"], Pm)
            tips = pruner.tips
            root_k, ls_k = PC.pruning_down(lr, pstep, tips)
            torch.cuda.synchronize()
            root_p, ls_p = PC.pruning_down_plain(lr, pstep, tips)
            raw, plan, root, ls = new_walk(torch, lr, pstep, tips)
            K, S, P = pruner.K, pruner.S, pruner.P
            name = f"d{i}_n{n}_P{P}_S{S}_K{K}_C{C}"
            err = compare(
                torch, site_lnl(torch, root_k, ls_k, pi),
                site_lnl(torch, root_p, ls_p, pi),
                f"pruning_down hymfossil division {i} n_tips={n} P={P} S={S} "
                f"K={K} C={C} ({plan['walk']} walk, {plan['threads']} "
                f"threads for {plan['T']} patterns, {plan['lanes']} lanes, "
                f"{plan['smem_bytes']} B shared; {int(zero.sum())} "
                f"zero-length branches)")
            worst = max(worst, err)
            flops = 2 * C * (n - 1) * 2 * K * S * S * P
            nbytes = 4 * (lr.numel() + pstep.numel() + tips.numel()
                          + root.numel() + ls.numel())
            cases[name] = {
                **plan, "max_abs_err": err,
                "ms": time_graph(torch, raw),
                "before_ms": time_graph(torch, old_walk(torch, lr, pstep,
                                                        tips)),
                "plain_ms": time_events(
                    torch, lambda: PC.pruning_down_plain(lr, pstep, tips), 3),
                **{k: v for k, v in bound(nbytes, flops).items()
                   if k in ("bound_ms", "bound_by")}}
            log(f"pruning_down hymfossil timing {name}: "
                f"{json.dumps(cases[name])}")
    return worst, cases


def hymfossil_row_state(torch, rec, taxa):
    """A hymfossil_fbd_totev row's state on the card (one chain)."""
    from mrbayes_tpu_torch.trees import parse_newick
    t = parse_newick(rec["newick"], taxa, rooted=True)
    st = tree_state(torch, t)
    del st["blen"]
    for k, v in rec["state"].items():
        if not k.startswith("_"):
            a = np.asarray(v)[None]
            st[k] = torch.as_tensor(a, device=DEV).to(
                torch.long if k == "sa" else torch.float32)
    return st


def phase_golden_hymfossil(torch):
    """The hymfossil_fbd_totev rows of tests/golden_extra.json through the
    port's CLI and engine with every kernel-path switch off and with the
    multiwalk, wavefront and stacked paths: each path's total within the
    row's tol (3.0) of reference MrBayes, each division's lnL within
    GOLDEN_PATH_TOL of the other paths', each path's kernel launched for
    every row."""
    from mrbayes_tpu_torch.ops.wavefront_cuda import PruningCudaWavefront
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] == "hymfossil_fbd_totev"]
    it = hymfossil_interpreter()
    lnl, per_div, launches = {}, {}, {}
    for path in ("off", "multiwalk", "wavefront", "stacked"):
        eng = it.build_engine(**({path: True} if path != "off" else {}))
        lnl[path], per_div[path] = [], []
        for rec in rows:
            st = eng.refresh_eigs(hymfossil_row_state(torch, rec,
                                                      eng.data.taxa))
            lnl[path].append(eng.log_likelihood(st)[0].item())
            per_div[path].append(eng.division_lnls(st)[0].cpu())
        used = {"off": [p for p in eng._pruners
                        if not isinstance(p, PruningCudaWavefront)],
                "wavefront": [p for p in eng._pruners
                              if isinstance(p, PruningCudaWavefront)],
                "stacked": [p for _, p in eng._stacked_pruners],
                "multiwalk": [p for _, p in eng._multiwalk_pruners]}[path]
        launches[path] = sum(p.launches for p in used)
        if not used or min(p.launches for p in used) < 2 * len(rows):
            raise AssertionError(f"golden hymfossil, {path} path: its kernel "
                                 f"was not launched for every row")
    worst = max(abs(v - rec["lnL"]) for vals in lnl.values()
                for v, rec in zip(vals, rows))
    spread = 0.0
    for r in range(len(rows)):
        t = torch.stack([v[r] for v in per_div.values()])
        spread = max(spread, float((t.max(0).values - t.min(0).values).max()))
    tol = rows[0]["tol"]
    log(f"golden hymfossil_fbd_totev: {len(rows)} rows, lnL by path "
        f"{json.dumps(lnl)}, reference {[r['lnL'] for r in rows]}, max "
        f"|lnL - reference| {worst:.4f} (limit {tol}), max spread of one "
        f"division's lnL between paths {spread:.2e} (limit "
        f"{GOLDEN_PATH_TOL}); launches {json.dumps(launches)}")
    if worst >= tol or spread > GOLDEN_PATH_TOL:
        raise AssertionError("golden hymfossil rows outside their limits")
    return worst, spread, launches["off"]


def zero_length_tips(tree_line):
    """Tip labels with a zero branch length in one .t tree line."""
    import re
    return re.findall(r"[(,](\d+):0(?=[,)])", tree_line)


@contextlib.contextmanager
def pinned_samples():
    """Check every sample a run writes: on every chain of the sample's
    host states, each sampled ancestor's parent at the fossil's age bit
    for bit.  Yields the record {"samples", "chains", "sampled_ancestors",
    "unpinned"}."""
    from mrbayes_tpu_torch.mcmc.run import McmcRunner
    rec = {"samples": 0, "chains": 0, "sampled_ancestors": 0, "unpinned": 0}
    write = McmcRunner._write_sample

    def checked(self, gen, host):
        age, parent = np.asarray(host["age"]), np.asarray(host["parent"])
        sa = np.asarray(host["sa"]) > 0
        n = sa.shape[1]
        par_age = np.take_along_axis(age, parent[:, :n], 1)
        rec["samples"] += 1
        rec["chains"] += age.shape[0]
        rec["sampled_ancestors"] += int(sa.sum())
        rec["unpinned"] += int((par_age[sa] != age[:, :n][sa]).sum())
        return write(self, gen, host)

    McmcRunner._write_sample = checked
    try:
        yield rec
    finally:
        McmcRunner._write_sample = write


def phase_hymfossil_cli(torch, ngen, power_line):
    """hymfossil's FBD analysis through the CLI, 2 runs x 4 chains, every
    kernel-path switch off: one pruning.cu launch a division and
    likelihood, carried versus recomputed scores, every fixed fossil age
    held, the pinned ages ordered and no constraint broken, every sampled
    ancestor's parent at its fossil's age bit for bit on every chain of
    every sample, complete .p/.t/.mcmc files whose sampled ancestors
    (nSampledAncestors) are the zero-length tip branches of the same
    sample's tree, sump and sumt.  Prints each run's mean
    nSampledAncestors and the gens/s beside HYM_GENS_PER_S_BEFORE (no
    gate on a count: 300 generations may hold none)."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.mcmc import clock as CL
    workdir = os.path.join(OUT, "hymfossil")
    shutil.rmtree(workdir, ignore_errors=True)
    with pinned_samples() as pins:
        it, stats, lines = run_batch(
            "hymfossil", workdir, ngen, device=DEV, diagnfreq=ngen // 2,
            multiwalk=False, wavefront=False, stacked=False)
    runner = it._last_runner
    eng = runner.eng
    final = runner.final_states
    calls = ngen + 1
    per = [p.launches for p in eng._pruners]
    if per != [calls] * eng.n_div:
        raise AssertionError(f"hymfossil launches {per}, predicted {calls} "
                             f"for each of {eng.n_div} divisions")
    assert_carried(eng, final, runner.final_bk)
    fossil = torch.as_tensor(np.flatnonzero(eng.fossil_tips), device=DEV)
    want = torch.as_tensor(eng.tip_dates[eng.fossil_tips],
                           dtype=torch.float32, device=DEV)
    if not (final["age"][:, fossil] == want).all():
        raise AssertionError("a fixed fossil age moved")
    pinned = CL.pin_sa_ages(final, eng.n_tips)
    if not CL.ages_ordered(pinned).all() \
            or (eng._constraint_terms(pinned) != 0).any():
        raise AssertionError("hymfossil final states break the ordering or "
                             "a constraint")
    if pins["samples"] == 0 or pins["unpinned"] \
            or not torch.equal(pinned["age"], final["age"]):
        raise AssertionError(f"hymfossil: a sampled ancestor's parent off "
                             f"its fossil's age ({json.dumps(pins)})")
    for phrase in ("Average PSRF for parameter values",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    sf = eng.mcmc.samplefreq
    expect_rows = ngen // sf + 1 + (ngen % sf > 0)     # the last sample too
    n_sa, sa_runs = [], {}
    for r in (1, 2):
        prefix = os.path.join(workdir, f"hymfossil.run{r}")
        with open(prefix + ".p") as f:
            f.readline()
            header = f.readline().rstrip("\n").split("\t")
            rows = [ln.rstrip("\n").split("\t") for ln in f
                    if ln[:1].isdigit()]
        with open(prefix + ".t") as f:
            trees = [ln for ln in f.read().splitlines() if "tree gen." in ln]
        if len(rows) != expect_rows or len(trees) != expect_rows \
                or not os.path.exists(os.path.join(workdir,
                                                   "hymfossil.mcmc")):
            raise AssertionError(f"hymfossil.run{r}: {len(rows)} .p rows, "
                                 f"{len(trees)} trees, expected "
                                 f"{expect_rows}, or no .mcmc file")
        col = header.index("nSampledAncestors")
        for row, tree in zip(rows, trees):
            k = int(float(row[col]))
            if len(zero_length_tips(tree)) != k:
                raise AssertionError(f"hymfossil.run{r} gen {row[0]}: {k} "
                                     f"sampled ancestors, tree has "
                                     f"{zero_length_tips(tree)}")
            n_sa.append(k)
            sa_runs.setdefault(f"run{r}", []).append(k)
    out = {**stats, "launches": sum(per), "launches_per_gen": sum(per) / calls,
           "sampled_ancestors_max": max(n_sa),
           "sampled_ancestors_mean": float(np.mean(n_sa)),
           "sampled_ancestors_mean_per_run": {
               r: float(np.mean(v)) for r, v in sa_runs.items()},
           "pinned_check": pins}
    log(f"hymfossil through the CLI, switches off: {json.dumps(out)}; card "
        f"{power_line}")
    log(f"hymfossil nSampledAncestors, mean of each run's samples: "
        f"{json.dumps(out['sampled_ancestors_mean_per_run'])}; "
        f"{pins['sampled_ancestors']} sampled ancestors over "
        f"{pins['chains']} chain samples, every one at its parent's age; "
        f"{out['gens_per_s']:.1f} gens/s against the {HYM_GENS_PER_S_BEFORE} "
        f"that PERF.md records from before sampled ancestors were accepted "
        f"(not measured in this run)")
    return it, out


def hymfossil_dataset(ntax=8, nchar=60, seed=5):
    """A small random DNA matrix (the JAX package's tests/test_fbd.py
    _mini_dataset) for the prior-only dating checks."""
    from mrbayes_tpu_torch.data import DataSet, make_divisions
    from mrbayes_tpu_torch.nexus.datatypes import DataType, FormatInfo
    from mrbayes_tpu_torch.nexus.parser import CharacterMatrix
    rng = np.random.default_rng(seed)
    codes = (1 << rng.integers(0, 4, size=(ntax, nchar))).astype(np.uint32)
    m = CharacterMatrix(taxa=[f"t{i}" for i in range(ntax)], nchar=nchar,
                        fmt=FormatInfo(datatype=DataType.DNA), codes=codes,
                        col_datatype=[DataType.DNA] * nchar)
    return DataSet(taxa=m.taxa, nchar=nchar, divisions=make_divisions(m))


def dating_settings(kind):
    """The small dating problems of the sync and prior-only checks:
    "fbd", the FBD prior on 8 tips with two fixed fossils and one dated
    uniformly (sampled ancestors, the tip-date slider), and "cpp", the CPP
    clock on a uniform prior with the same dated tips and a calibrated
    hard constraint; "mixed" adds the IGR/ILN switch to the latter."""
    from mrbayes_tpu_torch.mcmc.settings import Prior, TreeSettings
    tips = {0: Prior("fixed", (0.5,)), 1: Prior("fixed", (0.3,)),
            2: Prior("uniform", (0.2, 0.8))}
    if kind == "fbd":
        return TreeSettings(clock=True, clockpr="fossilization",
                            samplestrat="random", sampleprob=0.7,
                            clockratepr=Prior("exponential", (10.0,)),
                            treeagepr=Prior("gamma", (2.0, 2.0)),
                            tip_calibrations=tips)
    mask = np.zeros(8, bool)
    mask[[4, 5, 6]] = True
    return TreeSettings(clock=True, clockpr="uniform",
                        clockvarpr="cpp" if kind == "cpp" else "mixed",
                        cppratepr=Prior("exponential", (1.0,)),
                        treeagepr=Prior("gamma", (2.0, 2.0)),
                        tip_calibrations=tips,
                        constraints=[("c", mask, Prior("uniform",
                                                       (0.0, 5.0)))])


def dating_engine(kind, device, nruns=1, nchains=4, seed=3, use_data=True):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    return Engine(hymfossil_dataset(), [DivisionSettings(nst="1")],
                  tree_settings=dating_settings(kind),
                  mcmc=McmcSettings(nruns=nruns, nchains=nchains, seed=seed,
                                    use_data=use_data), device=device)


def phase_dating_sync(torch, it, power_line):
    """A block and one generation of every move type with host
    synchronisation made an error: the hymfossil engine (the FBD moves,
    add_branch and del_branch) and the small dating problems (the
    tip-date slider, the CPP moves, rcl_jump, the constraint terms).
    Returns each engine's moves."""
    engines = {"hymfossil": it.build_engine(),
               **{k: dating_engine(k, DEV) for k in ("fbd", "cpp",
                                                     "mixed")}}
    out = {}
    for name, eng in engines.items():
        states, bk = eng.init_chains()
        states, bk = eng.run_block(states, bk, 10)
        sync_checked(torch, eng, states, bk, SYNC_GENS)
        out[name] = [m.name for m in eng.moves]
    need = {"add_branch", "del_branch", "tip_date_slider",
            "fossilization_slider", "cpp_adddelete", "cpp_position",
            "cpp_multiplier", "cpprate_mult", "rcl_jump"}
    missing = need - set().union(*map(set, out.values()))
    if missing:
        raise AssertionError(f"dating sync check missed {missing}")
    log(f"dating: no host sync in a {SYNC_GENS}-gen block or in any move "
        f"type of {json.dumps(out)}; card {power_line}")
    return out


def dating_prior_stats(torch, kind, device, seed):
    """mcmc data=no on a small dating problem, DATING_PRIOR_RUNS runs x 1
    chain for DATING_PRIOR_GENS generations on ``device``: per run, the
    means over the second half of the root age and of the number of
    sampled ancestors ("fbd") or CPP events ("cpp"), recorded every 10
    generations."""
    eng = dating_engine(kind, device, nruns=DATING_PRIOR_RUNS, nchains=1,
                        seed=seed, use_data=False)
    states, bk = eng.init_chains()
    root = eng.n_nodes - 1
    count = "sa" if kind == "fbd" else "cpp_n"
    rec = []
    t0 = time.perf_counter()
    for _ in range(DATING_PRIOR_GENS // 10):
        states, bk = eng.run_block(states, bk, 10)
        rec.append(torch.stack([states["age"][:, root],
                                states[count].sum(1).float()], 1))
    x = torch.stack(rec).cpu().numpy()
    rate = DATING_PRIOR_GENS / (time.perf_counter() - t0)
    return x[x.shape[0] // 2:].mean(0), rate           # [runs, 2]


def phase_three_tips(torch, power_line):
    """The three-tip prior-only FBD problem on the card
    (``tests/fbd_small_trees.py``: two extant tips and a fossil, each
    chain drawing its own move) against the float64 integral of
    ``ln_fbd`` over its state space: the sampled-ancestor share (> 0),
    their mean count, the mean root age and the share of ((A,B),F) within
    4 batch-means standard errors, one batch a run."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import fbd_small_trees as FS
    fossil_ages = FS.PROBLEMS["three_tips"]
    want = FS.integral(fossil_ages)
    eng = FS.engine(fossil_ages, DEV, THREE_TIP_RUNS, THREE_TIP_SEED)
    t0 = time.perf_counter()
    x = FS.sampler(eng, THREE_TIP_GENS, THREE_TIP_BURN, THREE_TIP_SEED)
    sec = time.perf_counter() - t0
    mean, se = x.mean(0), x.std(0, ddof=1) / np.sqrt(THREE_TIP_RUNS)
    names = FS.STATS
    out = {nm: {"card": float(mean[j]), "integral": want[nm],
                "se": float(se[j]),
                "z": float((mean[j] - want[nm]) / se[j])}
           for j, nm in enumerate(names)}
    out.update(runs=THREE_TIP_RUNS, gens=THREE_TIP_GENS,
               burn=THREE_TIP_BURN, seconds=sec,
               gens_per_s=THREE_TIP_GENS / sec)
    log(f"three-tip prior-only FBD on the card against its integral: "
        f"{json.dumps(out)}; card {power_line}")
    if mean[0] <= 0 or any(abs(out[nm]["z"]) >= 4.0 for nm in names):
        raise AssertionError("three-tip FBD sampler off its integral")
    return out


def phase_dating_prior(torch, power_line):
    """The prior-only FBD (8 tips, 3 dated fossils) and CPP problems on the
    card against the port's own CPU engine on the same settings and seed:
    the mean root age and the mean number of sampled ancestors or CPP
    events within 4 batch-means standard errors (one batch a run, both
    sides' errors together), and sampled ancestors on both sides; then
    the three-tip problem against its integral (``phase_three_tips``)."""
    out, bad = {}, []
    for kind, stat in (("fbd", "sampled_ancestors"), ("cpp", "cpp_events")):
        res = {dev: dating_prior_stats(torch, kind, dev, 21)
               for dev in (DEV, "cpu")}
        out[kind] = {"gens_per_s": {d: r for d, (_, r) in res.items()}}
        for j, nm in enumerate(("root_age", stat)):
            (g, _), (c, _) = res[DEV], res["cpu"]
            se = float(np.hypot(g[:, j].std(ddof=1), c[:, j].std(ddof=1))
                       / np.sqrt(DATING_PRIOR_RUNS))
            d = float(g[:, j].mean() - c[:, j].mean())
            out[kind][nm] = {"card": float(g[:, j].mean()),
                             "cpu": float(c[:, j].mean()), "se": se,
                             "z": d / se if se > 0 else 0.0}
            if abs(d) > 4.0 * se:
                bad.append(f"{kind} {nm}")
        if kind == "fbd" and not min(r[:, 1].mean()
                                     for r, _ in res.values()) > 0:
            bad.append("fbd: no sampled ancestor on one side")
    log(f"prior-only dating, card against the CPU engine, "
        f"{DATING_PRIOR_RUNS} runs x 1 chain, {DATING_PRIOR_GENS} gens: "
        f"{json.dumps(out)}; card {power_line}")
    if bad:
        raise AssertionError(f"prior-only dating marginals disagree: {bad}")
    out["three_tips"] = phase_three_tips(torch, power_line)
    return out


# ---------------------------------------------------------------------------
# kim.nex's stem doublets, codon M3 and M10, and unlinked trees

def tiled_designs(torch, lr, pstep, tips):
    """The tiled walk's other designs on the same operands: every cluster
    size in (the rule's, 1: all categories in one block) and every T that
    fits, each launched through ``pruning_cuda.tiled_plan``, its largest
    difference of root and ls to the rule's launch (0: the same bits) and
    its CUDA-graph time."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    C, K, S = lr.shape[0], *pstep.shape[3:5]
    n_tips, _, P = tips.shape
    ref = PC.pruning_down(lr, pstep, tips)
    out = {}
    for Q in (PC.tiled_cluster(K), 1):
        for T in (32, 16, 8, 4):
            plan = PC.tiled_plan(C, n_tips, K, S, P, lr.device, Q, T)
            if plan["walk"] != "tiled":
                continue
            root = torch.empty((C, K, S, P), device=lr.device)
            ls = torch.empty((C, P), device=lr.device)

            def raw():
                PC.pruning_launch(lr, pstep, tips, None, root, ls, plan)
            err = PC.pruning_launch(lr, pstep, tips, None, root, ls, plan)
            if err != 0:
                raise PC.launch_error(PC.library().lib, err, "tiled design")
            torch.cuda.synchronize()
            out[f"Q{Q}_T{T}"] = {
                "threads": plan["threads"], "smem_bytes": plan["smem_bytes"],
                "vs_rule_max_abs": max((root - ref[0]).abs().max().item(),
                                       (ls - ref[1]).abs().max().item()),
                "ms": time_graph(torch, raw, 10, 3)}
    return out


def phase_kim_codon_kernels(torch):
    """pruning.cu against its plain version at the shapes this slice's
    main paths give it (``KIM_CODON_SHAPES``), C = 8 and 32: the walk and
    block the size rule chose (M3 staged, M10 and the 114-taxon codon
    shapes the tiled walk), ms, before_ms (the old global walk, one launch
    a graph and two replays at 114 taxa, where it takes 0.1-0.3 s), the
    largest difference to it, plain_ms and the bound; at the tiled shapes
    also the tiled walk's other designs (``tiled_designs``)."""
    worst, cases = 0.0, {}
    for i, (n_tips, P, S, K) in enumerate(KIM_CODON_SHAPES):
        for C in (8, 32):
            big = n_tips > 100
            rec, ops, _, _ = pruning_check(
                torch, (n_tips, P, S, K, C), 500 + 2 * i + (C == 32),
                KIM_CODON_WALKS.get((n_tips, P, S, K)), plain=True, n=20,
                reps=3, loops=20, before_n=1 if big else None,
                before_reps=2 if big else None,
                before_loops=0 if big else None)
            if rec["walk"] == "tiled":
                rec["designs"] = tiled_designs(torch, *ops)
                log(f"tiled walk's designs n_tips={n_tips} P={P} S={S} K={K} "
                    f"C={C}: {json.dumps(rec['designs'])}")
            cases[f"n{n_tips}_P{P}_S{S}_K{K}_C{C}"] = rec
            worst = max(worst, rec["max_abs_err"])
    return worst, cases


def phase_kim_codon_eigh(torch):
    """eigh.cu against its plain version and its first design at the
    batches of this slice's main paths (``KIM_EIGH_CASES``: the doublet's
    runtime S 16, M10's eight omega classes a chain at S 61), with
    ``eigh_case``'s gates and times."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    rng = np.random.default_rng(302)
    cases = {f"B{B}_S{S}": eigh_case(torch, E,
                                     reversible_batch(torch, rng, B, S))
             for B, S in KIM_EIGH_CASES}
    for key, case in cases.items():
        log(f"eigh_cuda timing {key}: {json.dumps(case)}")
    return cases


def row_engine(rec):
    """The port's engine on the card for a golden row's commands, its
    execute pointed at the file of that name under tests/data or at the
    vendored example."""
    from mrbayes_tpu_torch.cli import Interpreter
    it = Interpreter(log=lambda m: None, device=DEV)
    for c in rec["commands"]:
        if c.startswith("execute "):
            base = os.path.basename(c.split()[1])
            local = os.path.join(HERE, "tests", "data", base)
            c = "execute " + (local if os.path.exists(local)
                              else os.path.join(EXAMPLES, base))
        it.run_line(c)
    return it.build_engine()


def phase_golden_kim_codon(torch):
    """The kim_hky_g_mixed4, kim_stems_doublet_gtr, kim_protein_gtr and
    replicase_m10 rows of tests/golden_extra.json on the card, each within
    its row's tol, and M10's class omegas within rtol 0.02 (atol 5e-3) of
    the reference's printed ones.  Returns the worst gap of each and the
    pruning.cu and eigh.cu launches they made."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] in GOLDEN_KIM_CODON]
    out, engines = {}, {}
    E.EIGH.launches = 0
    for rec in rows:
        name = rec["name"]
        eng = engines.get(name) or engines.setdefault(name, row_engine(rec))
        st = tree_state(torch, parse_newick(rec["newick"], eng.data.taxa))
        for k, v in rec["state"].items():
            if not k.startswith("_"):
                st[k] = torch.tensor([v], dtype=torch.float32, device=DEV)
        gap = abs(eng.log_likelihood(eng.refresh_eigs(st))[0].item()
                  - rec["lnL"])
        out[name] = max(out.get(name, 0.0), gap)
        if not gap < rec["tol"]:
            raise AssertionError(f"golden {name}@{rec['gen']}: |lnL - "
                                 f"reference| {gap} >= {rec['tol']}")
        if "_ref_omegas" in rec["state"]:
            ours = eng._m10_omegas_weights(st, eng.div_cfg[0])[0][0]
            ref = np.asarray(rec["state"]["_ref_omegas"])
            d = np.abs(ours.cpu().numpy() - ref)
            out["replicase_m10_omegas"] = max(
                out.get("replicase_m10_omegas", 0.0), float(d.max()))
            if not (d <= 5e-3 + 0.02 * np.abs(ref)).all():
                raise AssertionError(f"M10 omegas {ours} vs the "
                                     f"reference's {ref}")
    launches = {"pruning_down": sum(p.launches for e in engines.values()
                                    for p in e._pruners),
                "eigh": E.EIGH.launches}
    log(f"golden kim and replicase M10 rows: max |lnL - reference| "
        f"{json.dumps(out)} (limits "
        f"{ {r['name']: r['tol'] for r in rows} }), launches "
        f"{json.dumps(launches)}")
    return out, launches


def phase_kim_codon_cli(torch, name, ngen, power_line):
    """``name`` (kim_doublet, replicase_m10, replicase_m3 or kim_unlinked,
    ``envelope.BATCHES``) through the CLI, 2 runs x 4 chains, every
    kernel-path switch off: one pruning.cu launch a division and
    likelihood (no division groups), eigh.cu once per fixed eigensystem at
    the build and once per refresh and division whose Q goes through it,
    carried versus recomputed scores, complete .p, .t (one a tree
    parameter) and .mcmc files, sump and sumt (one consensus a tree).  The
    engine is built inside ``execute_file``: its counts start at 0 there,
    eigh.cu's is set to 0 just before, and both are read when the run is
    over."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    workdir = os.path.join(OUT, name)
    shutil.rmtree(workdir, ignore_errors=True)
    E.EIGH.launches = 0                       # the main path's run starts
    it, stats, lines = run_batch(
        name, workdir, ngen, device=DEV, samplefreq=KIM_SAMPLEFREQ,
        diagnfreq=ngen // 2, multiwalk=False, wavefront=False, stacked=False)
    eigh_launches = E.EIGH.launches           # ... and ends here
    runner = it._last_runner
    eng = runner.eng
    calls = ngen + 1
    per = [p.launches for p in eng._pruners]
    if eng._multiwalk_pruners or eng._stacked_pruners \
            or per != [calls] * eng.n_div:
        raise AssertionError(f"{name} launches {per}, predicted {calls} for "
                             f"each of {eng.n_div} divisions")
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    C = eng.mcmc.nruns * eng.mcmc.nchains
    walks = [PC.pruning_plan(C, p.n_tips, p.K, p.S, p.P, DEV)["walk"]
             for p in eng._pruners]
    if name == "replicase_m10" and walks != ["tiled"]:
        raise AssertionError(f"{name}: pruning.cu walks {walks}, expected "
                             f"the tiled walk")
    expect_eigh = build_eigh_launches(eng) + solver_divisions(eng) \
        * solver_q_generations(eng, runner.final_bk)
    if eigh_launches != expect_eigh:
        raise AssertionError(f"{name}: {eigh_launches} eigh launches, "
                             f"predicted {expect_eigh}")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    prefix = os.path.join(workdir, name)
    expect_rows = ngen // KIM_SAMPLEFREQ + 1
    first = []
    for r in (1, 2):
        with open(f"{prefix}.run{r}.p") as f:
            rows = [ln for ln in f if ln[:1].isdigit()]
        first.append(float(rows[0].split("\t")[1]))
        for path in runner._tree_paths(r - 1):
            with open(path) as f:
                text = f.read()
            if text.count("tree gen.") != expect_rows \
                    or not text.rstrip().endswith("end;"):
                raise AssertionError(f"{path}: incomplete")
        if len(rows) != expect_rows:
            raise AssertionError(f"{name}.run{r}.p: {len(rows)} rows, "
                                 f"expected {expect_rows}")
    cons = ([f"{prefix}.tree{t + 1}.con.tre" for t in range(eng.n_trees)]
            if eng.n_trees > 1 else [f"{prefix}.con.tre"])
    if not all(os.path.exists(p) for p in cons + [f"{prefix}.mcmc"]):
        raise AssertionError(f"{name}: missing {cons} or its .mcmc file")
    if not stats["best_lnl"] > max(first):
        raise AssertionError(f"{name} best lnL {stats['best_lnl']} did not "
                             f"climb from the start {first}")
    out = {**stats, "launches": sum(per), "launches_per_gen": sum(per) / calls,
           "walks": walks,
           "eigh_launches": eigh_launches, "n_div": eng.n_div,
           "n_trees": eng.n_trees, "consensus_files": len(cons)}
    log(f"{name} through the CLI, switches off: {json.dumps(out)}; start "
        f"lnL {first}; card {power_line}")
    return it, out


def solver_divisions(eng):
    """The divisions whose Q goes through eigh.cu at every refresh: more
    than 8 states and an eigensystem that is not fixed."""
    return sum(1 for i in range(eng.n_div) if i not in eng._const_eigs
               and eng._model_tips[i].shape[2] > 8)


def phase_unlinked_lnl(torch, eng, states, power_line):
    """kim's unlinked trees: the tree groups JAX forms (6 trees over 8
    divisions, the morphology buckets on one), each division's lnL on its
    own tree through pruning.cu against the plain version within 1e-3
    (float64 pattern sums), and the carried total lnL against their sum."""
    if eng.n_trees != 6 or eng.div_tree != [0, 1, 2, 3, 4, 5, 5, 5]:
        raise AssertionError(f"kim by_gene: {eng.n_trees} trees, div_tree "
                             f"{eng.div_tree}")
    kernel = eng.division_lnls(states)
    pruners = eng._pruners
    eng._pruners = [None] * eng.n_div        # division_loglik's plain path
    try:
        plain = eng.division_lnls(states)
    finally:
        eng._pruners = pruners
    d = (kernel - plain).abs().max().item()
    total = (states["lnL"].double() - kernel.sum(-1)).abs().max().item()
    log(f"kim unlinked: per-division lnL through pruning.cu against the "
        f"plain version max |d| {d:.3e}, carried total against their sum "
        f"max |d| {total:.3e}; card {power_line}")
    if not (d <= 1e-3 and total <= 2e-2):
        raise AssertionError("kim unlinked: a division's lnL or the total "
                             "disagrees")
    return {"division_kernel_vs_plain": d, "total_vs_sum": total}


def covarion_engine(torch, name, C):
    """The port's engine of ``COVARION_ENGINES[name]`` on the card, 1 run
    x C chains."""
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.envelope import BATCHES
    batch, extra = COVARION_ENGINES[name]
    data, model = BATCHES[batch]
    it = Interpreter(log=lambda m: None, device=DEV, multiwalk=False,
                     wavefront=False, stacked=False)
    for line in (f"execute {data}", *model, *extra,
                 f"mcmcp nruns=1 nchains={C}"):
        it.run_line(line)
    return it.build_engine()


def covarion_state(torch, eng, rng):
    """The engine's starting chains (random trees) with seeded substitution
    parameters: gamma shapes, switch rates, kappa, frequencies, root
    frequencies; eigensystems refreshed."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    states, _ = eng.init_chains(int(rng.integers(1 << 30)))
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    draws = {"shape": lambda sh: rng.uniform(0.3, 2.0, sh),
             "covswitch": lambda sh: rng.uniform(0.2, 5.0, sh),
             "tratio": lambda sh: rng.uniform(0.5, 8.0, sh),
             "pi": lambda sh: rng.dirichlet(np.full(sh[-1], 5.0), sh[:-1]),
             "pi2": lambda sh: rng.dirichlet([3.0, 3.0], sh[:-1]),
             "rootpi2": lambda sh: rng.dirichlet([1.0, 1.0], sh[:-1])}
    for k, draw in draws.items():
        if k in st:
            st[k] = torch.as_tensor(draw(tuple(st[k].shape)),
                                    dtype=torch.float32, device=DEV)
    return eng.refresh_eigs(st)


def covarion_operands(torch, eng, st):
    """pruning.cu's operands (lr, pstep, tips) for division 0 of ``eng``
    at ``st``, the way its likelihood builds them, and the frequencies of
    its root reduction: a covarion division's per-category eigensystems
    with unit category rates and its doubled frequencies, else the generic
    division's (the root frequencies of a directional one)."""
    from mrbayes_tpu_torch.ops.pruning import branch_tiprobs
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    blen = eng.branch_lengths(st)
    pruner = eng._pruners[0]
    if eng.div_cfg[0].covarion:
        lam, U, Uinv = eng._division_eig_cached(st, 0)
        Pm = branch_tiprobs(blen, lam, U, Uinv,
                            eng._unit_rates.expand(1, pruner.K), 0.0)
        pi = eng._covarion_pi(st, 0)
    else:
        pi, _, lam, U, Uinv, rates, pinv, cmask, mult = \
            eng._generic_div_params(st, 0)
        Pm = branch_tiprobs(blen, lam, U, Uinv, rates,
                            pinv if cmask is not None else 0.0, mult)
    order = postorder_internal(st["parent"], eng.n_tips)
    lr, pstep = pruner.operands(order, st["left"], st["right"], Pm)
    return lr, pstep, pruner.tips, pi


def phase_covarion_kernels(torch):
    """pruning.cu against its plain version on the operands of this
    slice's engines (``COVARION_ENGINES``: real covarion generators, the
    switch blocks unscaled by the category rate; restriction with its
    coding dummies and root frequencies), C = 8 and 32: the walk and block
    the size rule chose (held to ``COVARION_WALKS`` and to ``size_rule``),
    ms, before_ms (the old global walk), plain_ms and the bound; then
    eigh.cu at [C K, 40, 40] on the avian covarion engine's symmetrised
    generators, with ``eigh_case``'s gates and times."""
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    worst, cases, eigh_cases = 0.0, {}, {}
    for i, name in enumerate(COVARION_ENGINES):
        for C in (8, 32):
            eng = covarion_engine(torch, name, C)
            rng = np.random.default_rng(700 + 2 * i + (C == 32))
            st = covarion_state(torch, eng, rng)
            p = eng._pruners[0]
            shape = (p.n_tips, p.P, p.S, p.K, C)
            rec, _, _, _ = pruning_check(
                torch, shape, None, COVARION_WALKS[name], plain=True,
                n=50, reps=3, loops=50, case=covarion_operands(torch, eng, st))
            key = f"{name}_n{p.n_tips}_P{p.P}_S{p.S}_K{p.K}_C{C}"
            cases[key] = rec
            worst = max(worst, rec["max_abs_err"])
            if name == "avian_covarion":
                Qc, pic = eng._covarion_q_pi(st, 0)
                sq = pic.double().sqrt()
                B = Qc.double() * (sq[..., :, None] / sq[..., None, :])
                A = (0.5 * (B + B.transpose(-1, -2))).reshape(-1, p.S, p.S)
                eigh_cases[f"B{A.shape[0]}_S{p.S}"] = eigh_case(
                    torch, E, A.contiguous())
    for key, case in eigh_cases.items():
        log(f"eigh_cuda covarion timing {key}: {json.dumps(case)}")
    return worst, cases, eigh_cases


def phase_golden_covarion(torch):
    """The primates_covarion_hky, restriction_directional and
    restriction_mixedfreq rows of tests/golden_extra.json on the card, each
    within its row's tol (1.0, 0.3, 0.3).  Returns the worst gap of each
    and the pruning.cu launches they made."""
    from mrbayes_tpu_torch.trees import parse_newick
    rows = [r for r in json.load(open(GOLDEN_EXTRA))
            if r["name"] in GOLDEN_COVARION]
    out, engines = {}, {}
    for rec in rows:
        name = rec["name"]
        eng = engines.get(name) or engines.setdefault(name, row_engine(rec))
        st = tree_state(torch, parse_newick(rec["newick"], eng.data.taxa,
                                            rooted=rec.get("rooted", False)))
        for k, v in rec["state"].items():
            st[k] = torch.tensor([v], device=DEV, dtype=(
                torch.int64 if k == "dirpi_on" else torch.float32))
        gap = abs(eng.log_likelihood(eng.refresh_eigs(st))[0].item()
                  - rec["lnL"])
        out[name] = max(out.get(name, 0.0), gap)
        if not gap < rec["tol"]:
            raise AssertionError(f"golden {name}@{rec['gen']}: |lnL - "
                                 f"reference| {gap} >= {rec['tol']}")
    launches = sum(p.launches for e in engines.values() for p in e._pruners)
    log(f"golden covarion and restriction rows: {len(rows)} rows, max |lnL "
        f"- reference| {json.dumps(out)} (limits "
        f"{ {r['name']: r['tol'] for r in rows} }), pruning_down launches "
        f"{launches}")
    return out, launches


def phase_covarion_cli(torch, name, power_line):
    """``name`` (``COVARION_CLI``, ``envelope.BATCHES``) through the CLI,
    4 chains, every kernel-path switch off: one pruning.cu launch a
    likelihood (ngen + 1), eigh.cu once per refresh of an eigensystem past
    8 states (avian's 40: the start, and every shape, switch-rate move),
    carried versus recomputed scores (from fresh eigensystems), complete
    .p and .t files (rooted [&R] trees under directional root
    frequencies, the rootpi and statefrmod columns, the switch rates'),
    sump and sumt, gens/s.  The engine is built inside ``execute_file``:
    its counts start at 0 there, eigh.cu's is set to 0 just before, and
    both are read when the run is over."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.ops import eigh_cuda as E
    nruns, ngen = COVARION_CLI[name]
    workdir = os.path.join(OUT, name)
    shutil.rmtree(workdir, ignore_errors=True)
    E.EIGH.launches = 0                       # the main path's run starts
    it, stats, lines = run_batch(
        name, workdir, ngen, device=DEV, samplefreq=COV_SAMPLEFREQ,
        diagnfreq=ngen // 2, nruns=nruns, multiwalk=False, wavefront=False,
        stacked=False)
    eigh_launches = E.EIGH.launches           # ... and ends here
    runner = it._last_runner
    eng = runner.eng
    calls = ngen + 1
    per = [p.launches for p in eng._pruners]
    if eng._multiwalk_pruners or eng._stacked_pruners \
            or per != [calls] * eng.n_div:
        raise AssertionError(f"{name} launches {per}, predicted {calls} for "
                             f"each of {eng.n_div} divisions")
    expect_eigh = build_eigh_launches(eng) + solver_divisions(eng) \
        * solver_q_generations(eng, runner.final_bk)
    if eigh_launches != expect_eigh:
        raise AssertionError(f"{name}: {eigh_launches} eigh launches, "
                             f"predicted {expect_eigh}")
    assert_carried(eng, runner.final_states, runner.final_bk)
    phrases = ["Credible sets of trees", "Consensus tree written to"]
    if nruns > 1:
        phrases.append("Average PSRF for parameter values")
    for phrase in phrases:
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    prefix = os.path.join(workdir, name)
    expect_rows = ngen // COV_SAMPLEFREQ + 1
    want_cols = {"primates_covarion": "s(on->off)",
                 "avian_covarion": "s(on->off)",
                 "restriction_directional": "rootpi(1)",
                 "restriction_mixed": "statefrmod"}[name]
    rooted = eng.rooted_nonclock
    for r in range(1, nruns + 1):
        with open(f"{prefix}.run{r}.p") as f:
            f.readline()
            header = f.readline().rstrip("\n").split("\t")
            rows = [ln for ln in f if ln[:1].isdigit()]
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        if len(rows) != expect_rows or want_cols not in header \
                or text.count("tree gen.") != expect_rows \
                or not text.rstrip().endswith("end;") \
                or (("[&R]" in text) != rooted):
            raise AssertionError(f"{name}.run{r}: {len(rows)} .p rows "
                                 f"(expected {expect_rows}), header "
                                 f"{header[:8]}..., or its .t file")
    out = {**stats, "launches": sum(per), "launches_per_gen": sum(per) / calls,
           "eigh_launches": eigh_launches, "nruns": nruns,
           "rooted_trees": rooted}
    log(f"{name} through the CLI, {nruns} run(s) x 4 chains, {ngen} gens, "
        f"switches off: {json.dumps(out)}; card {power_line}")
    log("\n".join(ln for ln in lines if "PSRF" in ln or "Credible" in ln
                  or "Consensus" in ln or "lnL" in ln[:40]))
    return it, out


def phase_covarion(torch, power_line):
    """Phases 38-41: the covarion group (``--phases covarion``)."""
    err, cases, eigh_cases = phase_covarion_kernels(torch)
    golden, golden_launches = phase_golden_covarion(torch)
    runs = {}
    for name in COVARION_CLI:
        it, runs[name] = phase_covarion_cli(torch, name, power_line)
        if name in ("avian_covarion", "restriction_mixed"):
            eng = it.build_engine()
            runs[name]["sync_eigh_launches"] = phase_aa_codon_sync(
                torch, f"{name} moves", eng, power_line,
                solver=solver_divisions(eng))
    return err, cases, eigh_cases, golden, golden_launches, runs


def family_engine(torch, name, C, device=DEV, **switches):
    """The port's engine of ``envelope.BATCHES[name]`` on ``device``, 1 run
    x C chains, every kernel-path switch off unless given (a continuous
    batch's matrix written from its seed under runs/)."""
    from mrbayes_tpu_torch.cli import Interpreter
    from mrbayes_tpu_torch.envelope import BATCHES, write_continuous
    data, model = BATCHES[name]
    if data is None:
        os.makedirs(OUT, exist_ok=True)
        data = write_continuous(os.path.join(OUT, f"{name}_data.nex"))
    it = Interpreter(log=lambda m: None, device=device, **{
        "multiwalk": False, "wavefront": False, "stacked": False,
        **switches})
    for line in (f"execute {data}", *model,
                 f"mcmcp nruns=1 nchains={C} seed=3"):
        it.run_line(line)
    return it.build_engine()


def family_state(torch, eng, rng):
    """The engine's starting chains (random trees) with seeded parameters:
    gamma or lognormal shapes, the adgamma correlation, kmixture rates,
    symbeta and the multistate frequencies under it, the Brownian variance
    rate; eigensystems refreshed."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    states, _ = eng.init_chains(int(rng.integers(1 << 30)))
    st = {k: v for k, v in states.items()
          if k not in SCORE_KEYS and not k.startswith("eig")}
    for k, v in st.items():
        sh = tuple(v.shape)
        if k in ("shape", "symbeta", "brownscale"):
            new = rng.uniform(0.3, 3.0, sh)
        elif k == "ratecorr":
            new = rng.uniform(-0.9, 0.9, sh)
        elif k == "mixtrates" or k.startswith("sympi"):
            new = rng.dirichlet(np.full(sh[-1], 3.0), sh[:-1])
        else:
            continue
        st[k] = torch.as_tensor(new, dtype=torch.float32, device=v.device)
    return eng.refresh_eigs(st)


def phase_family_kernels(torch):
    """Phase 42: pruning.cu against its plain version on the operands of
    cynmix's morphology under symdirihyperpr (``FAMILY_KERNEL_DIVS``: the
    binary bucket's 20 beta x gamma categories, each weighted at the root
    by its own frequencies, and the sampled-frequency buckets), C = 8 and
    32: the walk and block (held to the whole walk and to the size rule's
    twin), ms, before_ms (the old global walk), plain_ms and the bound."""
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    worst, cases = 0.0, {}
    for C in (8, 32):
        eng = family_engine(torch, "cynmix_symdiri", C)
        st = family_state(torch, eng, np.random.default_rng(800 + C))
        order = postorder_internal(st["parent"], eng.n_tips)
        for i in FAMILY_KERNEL_DIVS:
            p = eng._pruners[i]
            Pm, pi = eng.pruner_operands(st, i)
            lr, pstep = p.operands(order, st["left"], st["right"], Pm)
            rec, _, _, _ = pruning_check(
                torch, (p.n_tips, p.P, p.S, p.K, C), None, "whole",
                plain=True, n=50, reps=3, loops=50,
                case=(lr, pstep, p.tips, pi))
            cases[f"cynmix_symdiri_div{i}_n{p.n_tips}_P{p.P}_S{p.S}_K{p.K}"
                  f"_C{C}"] = rec
            worst = max(worst, rec["max_abs_err"])
    return worst, cases


def adgamma_forward64(eng, st, root, ls):
    """The adgamma lnL [C] of chains ``st`` by a float64 sequential forward
    algorithm over the card's own per-category root partials [C, K, S, P]
    and scalers, the engine's frequencies and transition matrices (powers
    taken in float64)."""
    cfg = eng.div_cfg[0]
    pi = eng._division_pi(st, 0).double().cpu().numpy()
    rP = np.einsum("cksp,cs->cpk", root.double().cpu().numpy(), pi)
    ls = ls.double().cpu().numpy()
    M = eng._adg_trans[cfg.n_rate_cats](
        st["ratecorr"][:, cfg.ratecorr_group]).double().cpu().numpy()
    poc, jump_idx, jumps = (x.cpu().numpy() if hasattr(x, "cpu") else x
                            for x in eng._adg_maps[0])
    out = []
    for c in range(rP.shape[0]):
        pows = [np.linalg.matrix_power(M[c], j) for j in jumps]
        F, logs = rP[c, poc[0]].copy(), 0.0
        for site in range(1, len(poc)):
            F = rP[c, poc[site]] * (pows[jump_idx[site]] @ F)
            m = F.max()
            F /= m
            logs += np.log(m)
        out.append(logs + np.log(F.mean()) + ls[c, poc].sum())
    return np.array(out)


def brownian_reml64(eng, st, c):
    """Chain c's continuous lnL by the dense multivariate-normal REML
    oracle (the contrasts x_i - x_0 under the tree's variance-covariance
    matrix, in float64; tests/test_continuous.py)."""
    t = eng.extract_tree(st, c)
    n = eng.n_tips

    def ancestors(v):
        out = set()
        while v != t.root:
            out.add(v)
            v = t.parent[v]
        return out

    anc = [ancestors(i) for i in range(n)]
    V = np.array([[sum(t.blen[v] for v in anc[i] & anc[j])
                   for j in range(n)] for i in range(n)])
    X = eng._cont_values[0].double().cpu().numpy()
    s2 = float(st["brownscale"][c, 0])
    D = np.zeros((n - 1, n))
    D[:, 0] = -1.0
    D[np.arange(n - 1), np.arange(1, n)] = 1.0
    W = D @ V @ D.T * s2
    _, logdet = np.linalg.slogdet(W)
    Y = D @ X
    quad = np.einsum("ic,ic->", Y, np.linalg.solve(W, Y))
    return float(-0.5 * (X.shape[1] * ((n - 1) * np.log(2 * np.pi)
                                       + logdet) + quad))


def fitch_lnl(eng, st, c, i):
    """Chain c's parsimony-model lnL of division i from a numpy Fitch
    count: -(T + n) log k."""
    t = eng.extract_tree(st, c)
    d = eng.div_cfg[i].div
    F = np.zeros((t.n_nodes, d.npat), np.uint32)
    F[:t.n_tips] = d.patterns
    T = 0.0
    for v in t.postorder():
        a, b = F[t.left[v]], F[t.right[v]]
        inter = a & b
        T += d.weights[inter == 0].sum()
        F[v] = np.where(inter > 0, inter, a | b)
    return -(T + d.weights.sum()) * np.log(max(2, d.n_states))


def phase_family_states(torch):
    """Phase 43: each family's engine on the card and on the CPU (the
    plain versions) at one state (the card's eigensystems carried over),
    ``FAMILY_STATE_CHAINS`` chains: each of the family's divisions' lnL
    per chain, and every other division's, within ``state_tol`` and lnP
    within 1e-4; then each family against an independent reference:
    adgamma against a float64 sequential forward over the card's own root
    partials (and the HMM's kernel launches counted), continuous against
    the dense REML oracle, parsmodel against a numpy Fitch count, each
    within ``FAMILY_LNL_TOL``."""
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    out = {}
    for n, name in enumerate(FAMILY_CLI):
        eng = family_engine(torch, name, FAMILY_STATE_CHAINS)
        cpu = family_engine(torch, name, FAMILY_STATE_CHAINS, device="cpu")
        st = family_state(torch, eng, np.random.default_rng(900 + n))
        a = eng.score(st)
        on_cpu = {k: v.cpu() for k, v in st.items()}
        b = cpu.score(on_cpu)
        fam = np.array([is_family_div(c) for c in eng.div_cfg])
        div_a = eng.division_lnls(st).cpu().numpy()
        div_b = cpu.division_lnls(on_cpu).numpy()
        d_div = np.abs(div_a - div_b)
        bound = state_tol(div_b, fam)
        d_lnp = (a["lnP"].cpu() - b["lnP"]).abs().max().item()
        rec = {"card_vs_cpu_lnl_by_division": d_div.max(0).tolist(),
               "bound_by_division": bound.min(0).tolist(),
               "abs_lnl_by_division": np.abs(div_b).min(0).tolist(),
               "family_divisions": np.flatnonzero(fam).tolist(),
               "card_vs_cpu_lnp": d_lnp, "lnl": a["lnL"].cpu().tolist()}
        if not (np.all(d_div < bound) and d_lnp < 1e-4):
            raise AssertionError(f"{name}: card vs CPU engine |dlnL| by "
                                 f"division {d_div.max(0)} against "
                                 f"{bound.min(0)}, |dlnP| {d_lnp}")
        lnl = a["lnL"].double().cpu().numpy()
        if name == "primates_adgamma":
            from torch.profiler import ProfilerActivity, profile
            Pm, _ = eng.pruner_operands(st, 0)
            order = postorder_internal(st["parent"], eng.n_tips)
            root, ls = eng._pruners[0](order, st["left"], st["right"], Pm)
            ref = adgamma_forward64(eng, st, root, ls)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eng._adgamma_from_root(st, 0, root, ls)
                torch.cuda.synchronize()
            rec["hmm_kernel_launches"] = sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            rec["sites"] = int(eng._adg_maps[0][0].numel())
            if not 0 < rec["hmm_kernel_launches"] < 200:
                raise AssertionError(f"adgamma HMM: {rec['hmm_kernel_launches']}"
                                     f" kernel launches for {rec['sites']} "
                                     f"sites")
        elif name == "continuous":
            ref = np.array([brownian_reml64(eng, st, c)
                            for c in range(FAMILY_STATE_CHAINS)])
        elif name == "cynmix_parsmodel":
            pars = [i for i, c in enumerate(eng.div_cfg) if c.parsimony]
            lnl = eng.division_lnls(st)[:, pars].sum(-1).cpu().numpy()
            ref = np.array([sum(fitch_lnl(eng, st, c, i) for i in pars)
                            for c in range(FAMILY_STATE_CHAINS)])
        else:
            ref = None
        if ref is not None:
            rec["vs_reference"] = float(np.abs(lnl - ref).max())
            if not np.all(np.abs(lnl - ref) < FAMILY_LNL_TOL):
                raise AssertionError(f"{name}: lnL {lnl} against the "
                                     f"reference {ref}")
        log(f"{name} at identical states, card vs CPU and reference: "
            f"{json.dumps(rec)}")
        out[name] = rec
    return out


def phase_family_multiwalk(torch):
    """Phase 44: primates by codon position under lnorm (1) and kmixture
    (2) with the multiwalk switch on: one multiwalk.cu launch for both
    divisions, each division's per-pattern lnL within 2e-5 of its own
    pruning.cu launch on the same operators, C = 8; the wrapper times of
    the group and of the two launches."""
    from mrbayes_tpu_torch.ops.pruning import site_loglik_from_root
    from mrbayes_tpu_torch.ops.traversal import postorder_internal
    eng = family_engine(torch, "primates_lnorm_kmix", 8, multiwalk=True)
    (idxs, gp), = eng._multiwalk_pruners
    if list(idxs) != [0, 1]:
        raise AssertionError(f"lnorm + kmixture group {idxs}")
    st = family_state(torch, eng, np.random.default_rng(950))
    ops = [eng.pruner_operands(st, i) for i in idxs]
    order = postorder_internal(st["parent"], eng.n_tips)
    args = (order, st["left"], st["right"])
    root, ls = gp(*args, [P for P, _ in ops])
    worst = 0.0
    for gi, i in enumerate(idxs):
        r, l = gp.div_view(root, ls, gi)
        r1, l1 = eng._pruners[i](*args, ops[gi][0])
        worst = max(worst, compare(
            torch, site_loglik_from_root(r, l, ops[gi][1], 0.0, None),
            site_loglik_from_root(r1, l1, ops[gi][1], 0.0, None),
            f"multiwalk lnorm+kmixture division {i + 1} vs pruning.cu"))
    rec = {"max_abs_err": worst, "ks": [eng.div_cfg[i].n_cats for i in idxs],
           "multiwalk_ms": time_events(
               torch, lambda: gp(*args, [P for P, _ in ops]), 50),
           "pruning_down_per_division_ms": time_events(
               torch, lambda: [eng._pruners[i](*args, ops[gi][0])
                               for gi, i in enumerate(idxs)], 50)}
    log(f"multiwalk lnorm + kmixture: {json.dumps(rec)}")
    return rec


def phase_family_cli(torch, name, power_line):
    """Phase 45: ``name`` (``FAMILY_CLI``, ``envelope.BATCHES``) through the
    CLI, 4 chains, ``FAMILY_GENS`` generations: one launch a likelihood of
    each division's kernel (pruning.cu, or the multiwalk group's; none for
    a parsimony-model or continuous division), carried versus recomputed
    scores, complete .p (finite, its family's column) and .t files, sump
    and sumt, gens/s.  The engine is built inside ``execute_file``: its
    counts start at 0 there and are read when the run is over."""
    from mrbayes_tpu_torch.envelope import run_batch
    nruns, switches = FAMILY_CLI[name]
    workdir = os.path.join(OUT, name)
    shutil.rmtree(workdir, ignore_errors=True)
    it, stats, lines = run_batch(
        name, workdir, FAMILY_GENS, device=DEV, samplefreq=FAMILY_SAMPLEFREQ,
        diagnfreq=FAMILY_GENS // 2, nruns=nruns, **{
            "multiwalk": False, "wavefront": False, "stacked": False,
            **switches})
    runner = it._last_runner
    eng = runner.eng
    calls = FAMILY_GENS + 1
    grouped = {i for g, _ in eng._multiwalk_pruners for i in g}
    per = [0 if p is None else p.launches for p in eng._pruners]
    expect = [0 if p is None or i in grouped else calls
              for i, p in enumerate(eng._pruners)]
    mw = sum(gp.launches for _, gp in eng._multiwalk_pruners)
    if per != expect or mw != calls * len(eng._multiwalk_pruners) \
            or eng._stacked_pruners:
        raise AssertionError(f"{name}: pruning_down launches {per} "
                             f"(predicted {expect}), multiwalk {mw}")
    assert_carried(eng, runner.final_states, runner.final_bk)
    phrases = ["Credible sets of trees", "Consensus tree written to"]
    if nruns > 1:
        phrases.append("Average PSRF for parameter values")
    for phrase in phrases:
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    prefix = os.path.join(workdir, name)
    expect_rows = FAMILY_GENS // FAMILY_SAMPLEFREQ + 1
    col = FAMILY_COLUMNS[name]
    for r in range(1, nruns + 1):
        with open(f"{prefix}.run{r}.p") as f:
            f.readline()
            header = f.readline().rstrip("\n").split("\t")
            rows = np.array([[float(x) for x in ln.split("\t")]
                             for ln in f if ln[:1].isdigit()])
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        if len(rows) != expect_rows or not np.isfinite(rows).all() \
                or (col is not None and col not in header) \
                or text.count("tree gen.") != expect_rows \
                or not text.rstrip().endswith("end;"):
            raise AssertionError(f"{name}.run{r}: {len(rows)} .p rows "
                                 f"(expected {expect_rows}), header "
                                 f"{header[:8]}..., or its .t file")
    out = {**stats, "pruning_down_launches": sum(per),
           "multiwalk_launches": mw,
           "launches_per_gen": (sum(per) + mw) / calls, "nruns": nruns}
    log(f"{name} through the CLI, {nruns} run(s) x 4 chains, {FAMILY_GENS} "
        f"gens, switches {switches or 'off'}: {json.dumps(out)}; card "
        f"{power_line}")
    log("\n".join(ln for ln in lines if "PSRF" in ln or "Credible" in ln
                  or "Consensus" in ln))
    return it, out


def phase_families(torch, power_line):
    """Phases 42-46: the families group (``--phases families``): the
    kernel at the symdiri shapes, the identical-state checks, the
    lnorm + kmixture multiwalk group, the five CLI runs and (46) a block
    and one generation of every move type of each with host
    synchronisation made an error."""
    err, cases = phase_family_kernels(torch)
    states = phase_family_states(torch)
    mw = phase_family_multiwalk(torch)
    runs = {}
    for name in FAMILY_CLI:
        it, runs[name] = phase_family_cli(torch, name, power_line)
        eng = it.build_engine()
        s, bk = eng.init_chains()
        sync_checked(torch, eng, s, bk, FAMILY_SYNC_GENS)
        log(f"{name}: no host sync in a {FAMILY_SYNC_GENS}-gen block or in "
            f"any of the {len(eng.moves)} move types "
            f"({', '.join(m.name for m in eng.moves)})")
    return max(err, mw["max_abs_err"]), cases, states, mw, runs


# ---------------------------------------------------------------------------
# the analyses group (phases 47-52): report, steppingstone, built starting
# trees, the commands and per-chain moves, each through the CLI


def cli_run(lines, device=None, log_to=None):
    """An ``Interpreter`` on ``device`` (the card by default) that ran
    ``lines``; returns (interpreter, the lines it logged)."""
    from mrbayes_tpu_torch.cli import Interpreter
    out = [] if log_to is None else log_to
    it = Interpreter(log=out.append, device=device or DEV)
    for line in lines:
        it.run_line(line)
    return it, out


def read_p(path):
    """(header, rows [n, columns]) of a .p file."""
    with open(path) as f:
        f.readline()
        header = f.readline().rstrip("\n").split("\t")
        rows = np.array([[float(x) for x in ln.split("\t")]
                         for ln in f if ln[:1].isdigit()])
    return header, rows


def syncs_during(torch, fn):
    """(fn(), the host synchronisations it made as "file:line" of the
    Python line that made each): the CUDA sync debug mode's warnings."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's one-time "prototype feature" notice is not a sync
    return out, [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                 for w in caught
                 if "called a synchronizing" in str(w.message)]


def cuda_kernels_during(torch, fn):
    """The CUDA kernels ``fn`` launched, by the profiler's device events
    (None where the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def golden_anc_engine(torch, ds, device):
    """The primates GTR+I+G engine with the apes constraint on ``device``
    and the golden ancestral-state rows' states as chains."""
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings, TreeSettings)
    from mrbayes_tpu_torch.trees import parse_newick
    with open(GOLDEN_ANC) as f:
        gold = json.load(f)
    mask = np.zeros(ds.ntax, bool)
    mask[[t - 1 for t in gold["constraint_taxa_1based"]]] = True
    ts = TreeSettings()
    ts.constraints = [("apes", mask, None)]
    eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")], ts,
                 mcmc=McmcSettings(nruns=1, nchains=1), device=device)
    trees = [parse_newick(r["newick"], ds.taxa) for r in gold["rows"]]
    st = {f: torch.as_tensor(np.stack([getattr(t, f) for t in trees]),
                             dtype=torch.long, device=device)
          for f in ("left", "right", "parent")}
    st["blen"] = torch.as_tensor(np.stack([t.blen for t in trees]),
                                 dtype=torch.float32, device=device)
    for k, f in (("pi", "pi"), ("revmat", "revmat"), ("shape", "alpha"),
                 ("pinvar", "pinvar")):
        st[k] = torch.tensor([[r[f]] if k in ("pi", "revmat")
                              else [r[f]] for r in gold["rows"]],
                             dtype=torch.float32, device=device)
    return eng, eng.refresh_eigs(st), gold, trees


def site_rate_oracle(ds, rec, t):
    """Posterior-mean site rates [P] of one golden row in float64 numpy
    (tests/test_report.py's oracle: GTR+G, P(t) by expm)."""
    from scipy.linalg import expm
    from scipy.stats import gamma as gamma_dist
    pi = np.array(rec["pi"])
    ex = np.array(rec["revmat"])
    Q = np.zeros((4, 4))
    k = 0
    for i in range(4):
        for j in range(i + 1, 4):
            Q[i, j], Q[j, i] = ex[k] * pi[j], ex[k] * pi[i]
            k += 1
    np.fill_diagonal(Q, -Q.sum(1))
    Q /= -(pi * np.diag(Q)).sum()
    a = rec["alpha"]
    cuts = gamma_dist.ppf(np.arange(1, 4) / 4, a, scale=1.0 / a)
    rates = 4 * np.diff(gamma_dist.cdf(np.r_[0, cuts * a, np.inf], a + 1))
    tp = ds.divisions[0].tip_partials(np.float64)
    P = np.array([[expm(Q * t.blen[v] * r) for r in rates]
                  for v in range(t.n_nodes)])
    cl = np.zeros((t.n_nodes, tp.shape[1], 4, 4))
    cl[:t.n_tips] = tp[:, :, None, :]
    for v in t.postorder():
        lc, rc = t.left[v], t.right[v]
        cl[v] = np.einsum("ksj,pkj->pks", P[lc], cl[lc]) \
            * np.einsum("ksj,pkj->pks", P[rc], cl[rc])
    Lk = np.einsum("pks,s->pk", cl[t.root], pi)
    return (Lk * rates).sum(-1) / Lk.sum(-1)


def phase_report_primates(torch, ds, power_line):
    """Phase 47: primates GTR+I+G with the apes constraint and ``report
    ancstates=yes siterates=yes`` through the CLI, 2 runs x 4 chains: the
    card's Reporter at the golden states against the reference's
    ancestral-state probabilities (1e-3 max, 2e-4 mean) and the float64
    oracle's site rates (0.02), every p(.){c@apes} row of the .p files
    summing to 1 within 1e-4, one host sync a sample (the runner's packed
    copy, the columns inside it), the report pass's kernels and ms."""
    from mrbayes_tpu_torch.mcmc.report import Reporter
    opts = {"ancstates": ("yes", (0,)), "siterates": ("yes", (0,))}
    eng, st, gold, trees = golden_anc_engine(torch, ds, DEV)
    rep = Reporter(eng, opts, log=lambda m: None)
    slots = torch.arange(len(gold["rows"]), device=DEV)
    vals = rep.compute(st, slots).cpu().numpy()
    errs = []
    col = {h: j for j, h in enumerate(rep.headers)}
    for gi, rec in enumerate(gold["rows"]):
        for c, probs in zip(rec["anc_chars"], rec["anc"]):
            for b, p_ref in zip("ACGT", probs):
                errs.append(abs(vals[gi, col[f"p({b}){{{c}@apes}}"]] - p_ref))
    errs = np.array(errs)
    if errs.max() >= 1e-3 or errs.mean() >= 2e-4:
        raise AssertionError(f"ancstates vs the reference: max "
                             f"{errs.max():.3g}, mean {errs.mean():.3g}")
    rbar = site_rate_oracle(ds, gold["rows"][0], trees[0])
    pat = ds.divisions[0].pattern_of_char
    rate_err = max(abs(vals[0, col[f"r({c})"]] - rbar[pat[c - 1]])
                   for c in range(1, ds.nchar + 1))
    if rate_err >= 0.02:
        raise AssertionError(f"site rates vs float64 oracle {rate_err}")
    report_ms = time_events(torch, lambda: rep.compute(st, slots), 10)
    try:
        report_kernels = cuda_kernels_during(
            torch, lambda: rep.compute(st, slots))
    except RuntimeError as e:       # a sandbox without CUPTI tracing
        log(f"report: the profiler recorded no kernels ({e})")
        report_kernels = None
    workdir = os.path.join(OUT, "report_primates")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    prefix = os.path.join(workdir, "rep")
    t0 = time.perf_counter()
    it, lines = cli_run([
        f"execute {PRIMATES}", "lset nst=6 rates=invgamma",
        "constraint apes = 3-7", "prset topologypr=constraints(apes)",
        "report ancstates=yes siterates=yes",
        f"mcmc ngen={REPORT_GENS} nruns=2 nchains=4 samplefreq="
        f"{ANALYSES_SAMPLEFREQ} printfreq={REPORT_GENS} diagnfreq="
        f"{REPORT_GENS} seed=5 file={prefix}"])
    run_s = time.perf_counter() - t0
    runner = it._last_runner
    launches = sum(p.launches for p in runner.eng._pruners)
    assert_carried(runner.eng, runner.final_states, runner.final_bk)
    worst = 0.0
    for r in (1, 2):
        header, rows = read_p(f"{prefix}.run{r}.p")
        if header[3 + len(runner.cols):] != runner.reporter.headers \
                or len(rows) != REPORT_GENS // ANALYSES_SAMPLEFREQ + 1 \
                or not np.isfinite(rows).all():
            raise AssertionError(f"rep.run{r}.p: header or rows")
        idx = {h: j for j, h in enumerate(header)}
        for c in range(1, ds.nchar + 1):
            s = sum(rows[:, idx[f"p({b}){{{c}@apes}}"]] for b in "ACGT")
            worst = max(worst, float(np.abs(s - 1.0).max()))
    if worst >= 1e-4:
        raise AssertionError(f"p(.){{c@apes}} rows sum to 1 +- {worst}")
    # the report pass makes no host sync; the sample's packed copy, the
    # columns inside it, makes one
    slots_r = runner.reporter.cold_slots(runner.final_bk)
    _, in_pass = syncs_during(torch, lambda: runner.reporter.compute(
        runner.final_states, slots_r))
    _, in_sample = syncs_during(torch, lambda: runner._host(
        runner.final_states, runner.final_bk))
    log(f"report: host syncs in the report pass {in_pass}, in a sample's "
        f"copy {in_sample}")
    if in_pass or len(in_sample) != 1:
        raise AssertionError(f"host syncs: {len(in_pass)} in the report "
                             f"pass (predicted 0), {len(in_sample)} for a "
                             f"sample (predicted 1)")
    syncs = len(in_sample)
    out = {"anc_max_err": float(errs.max()), "anc_mean_err":
           float(errs.mean()), "site_rate_max_err": float(rate_err),
           "row_sum_max_err": worst, "columns": len(rep.headers),
           "host_syncs_per_sample": syncs, "report_ms": report_ms,
           "report_cuda_kernels": report_kernels,
           "pruning_down_launches": launches, "gens": REPORT_GENS,
           "run_s": run_s, "gens_per_s": REPORT_GENS / run_s}
    log(f"report primates: {json.dumps(out)}; card {power_line}")
    return out


def phase_report_replicase(torch, power_line):
    """Phase 48: replicase under NY98 with ``report possel=yes
    siteomega=yes`` through the CLI, 1 run x 4 chains: the card's columns
    against the CPU's at the run's final state (every state tensor, the
    eigensystems included, carried over) within 1e-4, each pr+ in [0, 1]
    and each omega within the class omegas."""
    from mrbayes_tpu_torch.mcmc.report import Reporter
    workdir = os.path.join(OUT, "report_replicase")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    prefix = os.path.join(workdir, "rep")
    model = [f"execute {REPLICASE}", "lset nucmodel=codon omegavar=ny98",
             "report possel=yes siteomega=yes"]
    t0 = time.perf_counter()
    it, _ = cli_run(model + [
        f"mcmc ngen={REPORT_CODON_GENS} nruns=1 nchains=4 samplefreq="
        f"{ANALYSES_SAMPLEFREQ} printfreq={REPORT_CODON_GENS} diagnfreq="
        f"{REPORT_CODON_GENS} seed=5 file={prefix}"])
    run_s = time.perf_counter() - t0
    runner = it._last_runner
    eng = runner.eng
    launches = sum(p.launches for p in eng._pruners)
    states = runner.final_states
    slots = runner.reporter.cold_slots(runner.final_bk)
    card = runner.reporter.compute(states, slots).cpu().numpy()
    cpu_it, _ = cli_run(model, device="cpu")
    cpu_eng = cpu_it.build_engine()
    cpu = Reporter(cpu_eng, cpu_it.env.report, log=lambda m: None).compute(
        {k: v.cpu() for k, v in states.items()}, slots.cpu()).numpy()
    diff = float(np.abs(card - cpu).max())
    if diff >= 1e-4:
        raise AssertionError(f"possel/siteomega card vs CPU {diff}")
    n = card.shape[1] // 2
    cold = int(slots[0])
    omegas = [float(states["omega1"][cold, 0]), 1.0,
              float(states["omega3"][cold, 0])]
    if not ((card[:, :n] >= 0).all() and (card[:, :n] <= 1).all()
            and (card[:, n:] >= min(omegas) - 1e-4).all()
            and (card[:, n:] <= max(omegas) + 1e-4).all()):
        raise AssertionError("pr+ outside [0, 1] or omega outside the "
                             "class omegas")
    header, rows = read_p(f"{prefix}.run1.p")
    if "pr+(1,2,3)" not in header or not np.isfinite(rows).all():
        raise AssertionError("replicase .p: no pr+ columns or non-finite")
    out = {"card_vs_cpu_max": diff, "columns": card.shape[1],
           "pruning_down_launches": launches, "gens": REPORT_CODON_GENS,
           "run_s": run_s}
    log(f"report replicase NY98: {json.dumps(out)}; card {power_line}")
    return out


def phase_steppingstone(torch, ds, power_line):
    """Phase 49: ``ss`` on primates GTR+I+G (1 run x 4 chains, a short
    ladder) then ``sumss``, through the CLI: every step in the .ss file,
    its contributions equal to those recomputed from the sampled lnL
    within 1e-6, lnZ finite and below the highest lnL sampled; then a
    prior-only block at power 0 (primates, 1 x 4 at temp 0, exponential(10)
    branch lengths): the chains' mean tree length within 4 batch-means
    standard errors of the prior's 2.1 (each chain's batches of 200
    generations)."""
    from mrbayes_tpu_torch.mcmc import steppingstone as SS
    workdir = os.path.join(OUT, "steppingstone")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    prefix = os.path.join(workdir, "ss")
    sampled = []
    orig = SS.SsRunner._write_sample

    def record(self, gen, host):
        sampled.append(float(host["lnL"][self.eng.cold_indices(host)[0]]))
        orig(self, gen, host)

    SS.SsRunner._write_sample = record
    t0 = time.perf_counter()
    try:
        it, lines = cli_run([
            f"execute {PRIMATES}", "lset nst=6 rates=invgamma",
            f"ss ngen={SS_GENS} nsteps={SS_STEPS} samplefreq="
            f"{SS_SAMPLEFREQ} printfreq={SS_GENS} nruns=1 nchains=4 "
            f"seed=5 file={prefix}", f"sumss filename={prefix}"])
    finally:
        SS.SsRunner._write_sample = orig
    run_s = time.perf_counter() - t0
    runner = it._last_runner
    launches = sum(p.launches for p in runner.eng._pruners)
    assert_carried(runner.eng, runner.final_states, runner.final_bk)
    with open(prefix + ".ss") as f:
        rows = [ln.split() for ln in f if ln[:1].isdigit()]
    if [int(r[0]) for r in rows] != list(range(1, SS_STEPS + 1)):
        raise AssertionError(f".ss steps {[r[0] for r in rows]}")
    per = len(sampled) // SS_STEPS
    lnl = np.array(sampled).reshape(SS_STEPS, per)
    betas = SS.beta_ladder(SS_STEPS)
    worst = max(abs(float(r[3]) - SS.step_contribution(
        betas[k] - betas[k + 1], lnl[k])) for k, r in enumerate(rows))
    if worst >= 1e-6:
        raise AssertionError(f".ss contributions off by {worst}")
    lnz = sum(float(r[3]) for r in rows)
    if not (np.isfinite(lnz) and lnz < lnl.max()):
        raise AssertionError(f"lnZ {lnz} vs highest lnL {lnl.max()}")
    if not any("Marginal likelihood (SS)" in ln for ln in lines):
        raise AssertionError("sumss printed no marginal likelihood")
    # the power-0 block: the likelihood drops out of every ratio; temp=0
    # makes all four chains cold, four samplers of the prior
    pit, _ = cli_run([f"execute {PRIMATES}", "lset nst=6 rates=invgamma",
                      "prset brlenspr=unconstrained:exp(10)",
                      "mcmcp nruns=1 nchains=4 temp=0 seed=9"])
    eng = pit.build_engine()
    states, bk = eng.init_chains()
    bk = {**bk, "power": 0.0}
    states, bk = eng.run_block(states, bk, PRIOR_POWER_BURN)
    tls = []
    for _ in range(PRIOR_POWER_GENS // 10):
        states, bk = eng.run_block(states, bk, 10)
        tls.append((eng.branch_lengths(states) * eng._blen_mask).sum(1))
    tls = torch.stack(tls).cpu().numpy()                 # [samples, 4]
    # each chain's batches of 200 generations, past the tree length's
    # autocorrelation (about 70 generations at power 0 on the CPU): 20
    # batch means from 4 independent samplers
    means = tls.T.reshape(4 * PRIOR_POWER_GENS // 200, -1).mean(1)
    se = float(means.std(ddof=1) / np.sqrt(len(means)))
    if abs(tls.mean() - 2.1) >= 4 * se:
        raise AssertionError(f"power-0 tree length {tls.mean()} vs prior "
                             f"mean 2.1 (4 se = {4 * se})")
    out = {"steps": len(rows), "lnZ": lnz, "max_lnl": float(lnl.max()),
           "contribution_max_err": worst, "pruning_down_launches": launches,
           "gens": SS_GENS + SS_GENS // SS_STEPS, "run_s": run_s,
           "power0_tl_mean": float(tls.mean()), "power0_tl_se": se}
    log(f"steppingstone primates: {json.dumps(out)}; card {power_line}")
    return out


def phase_start_trees(torch, power_line):
    """Phase 50: cynmix (its matrix and model) with starttree=parsimony,
    then starttree=nj nperts=2, through the CLI (1 run x 4 chains): the
    cold chain's tree at generation 0 equal to the CPU port's from the same
    seed, the carried lnL/lnP equal to a recompute."""
    from mrbayes_tpu_torch.envelope import CYNMIX, CYNMIX_MODEL
    from mrbayes_tpu_torch.trees import to_newick
    out = {}
    for mode in ("starttree=parsimony", "starttree=nj nperts=2"):
        name = mode.split("=")[1].split()[0]
        workdir = os.path.join(OUT, f"start_{name}")
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        prefix = os.path.join(workdir, name)
        model = [f"execute {CYNMIX}", *CYNMIX_MODEL,
                 f"mcmcp nruns=1 nchains=4 seed=21 {mode}"]
        t0 = time.perf_counter()
        it, _ = cli_run(model + [
            f"mcmc ngen={START_GENS} samplefreq={START_GENS} printfreq="
            f"{START_GENS} diagnfreq={START_GENS} file={prefix}"])
        run_s = time.perf_counter() - t0
        runner = it._last_runner
        eng = runner.eng
        launches = sum(p.launches for p in eng._pruners)
        assert_carried(eng, runner.final_states, runner.final_bk)
        cpu_it, _ = cli_run(model, device="cpu")
        first = cpu_it.build_engine().init_state(np.random.default_rng(21))
        from mrbayes_tpu_torch.trees import Tree
        t = Tree(parent=first["parent"].astype(np.int32),
                 left=first["left"].astype(np.int32),
                 right=first["right"].astype(np.int32),
                 blen=first["blen"].astype(np.float64), n_tips=eng.n_tips)
        with open(prefix + ".run1.t") as f:
            gen0 = next(ln for ln in f if "tree gen.0 " in ln)
        if gen0.split("] ", 1)[1].strip() != to_newick(t, numbers=True):
            raise AssertionError(f"{name}: the run's starting tree differs "
                                 f"from the CPU port's")
        out[name] = {"pruning_down_launches": launches, "gens": START_GENS,
                     "run_s": run_s}
    log(f"start trees cynmix: {json.dumps(out)}; card {power_line}")
    return out


COMMANDS_SCRIPT = """#NEXUS
begin trees;
    tree mystart = ((1,2),((3,((4,5),6)),(7,((8,(9,10)),(11,12)))));
end;
begin mrbayes;
    set autoclose=yes nowarnings=yes seed=7 swapseed=9;
    execute "{primates}";
    lset nst=2 rates=equal;
    propset subtree_swap$prob=0 ext_spr$prob=20 ext_spr$tuning=0.7;
    startvals tau=mystart;
    mcmc ngen=400 nruns=2 nchains=2 samplefreq=100 printfreq=200
         diagnfreq=400 file={prefix};
    plot parameter=LnL;
    comparetree filename1={prefix}.run1.t filename2={prefix}.run2.t
                outputname={prefix}.cmp;
end;
"""
INFO_COMMANDS = ("showmodel", "showmatrix", "showmoves", "showparams",
                 "charstat", "taxastat", "showusertrees", "databreaks",
                 "citations", "about", "acknowledgments", "disclaimer",
                 "showbeagle", "showmcmctrees", "version", "help",
                 "help sumt")


def phase_commands(torch, power_line):
    """Phase 51: tests/test_commands.py's SCRIPT through the CLI (propset,
    startvals tau=mystart, mcmc, plot, comparetree), then compareref,
    delete 2 and an mcmc on the 11 taxa left, restore, outgroup, sump
    plot=yes and every informational command: each runs, each run's files
    are complete."""
    from mrbayes_tpu_torch.cli import Interpreter
    workdir = os.path.join(OUT, "commands")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    prefix = os.path.join(workdir, "out")
    script = os.path.join(workdir, "cmds.nex")
    with open(script, "w") as f:
        f.write(COMMANDS_SCRIPT.format(prefix=prefix, primates=PRIMATES))
    lines = []
    it = Interpreter(log=lines.append, device=DEV)
    t0 = time.perf_counter()
    it.execute_file(script)
    runner = it._last_runner
    launches = sum(p.launches for p in runner.eng._pruners)
    if "subtree_swap" in [m.name for m in runner.eng.moves]:
        raise AssertionError("propset subtree_swap$prob=0 not applied")
    assert_carried(runner.eng, runner.final_states, runner.final_bk)
    for r in (1, 2):
        header, rows = read_p(f"{prefix}.run{r}.p")
        with open(f"{prefix}.run{r}.t") as f:
            text = f.read()
        if len(rows) != 5 or text.count("tree gen.") != 5 \
                or not text.rstrip().endswith("end;"):
            raise AssertionError(f"out.run{r}: incomplete files")
    for line in (f"compareref filename1={prefix}.run1.t filename2={prefix} "
                 f"nruns=2 outputname={prefix}.cref", "outgroup 3",
                 f"sump filename={prefix} plot=yes", *INFO_COMMANDS,
                 f"manual {workdir}/commref.txt"):
        n = len(lines)
        it.run_line(line)
        if len(lines) == n and line != "outgroup 3":
            raise AssertionError(f"{line!r} printed nothing")
    # delete (in an interpreter of its own: the 12-taxon start tree above
    # does not fit 11 taxa), an mcmc on the taxa left, restore
    dprefix = os.path.join(workdir, "deleted")
    dit, dlines = cli_run([
        f"execute {PRIMATES}", "lset nst=2 rates=equal", "delete 2",
        f"mcmc ngen=100 nruns=1 nchains=2 samplefreq=50 file={dprefix}",
        "taxastat", "restore 2", "taxastat"])
    run_s = time.perf_counter() - t0
    launches += sum(p.launches for p in dit._last_runner.eng._pruners)
    with open(f"{dprefix}.run1.t") as f:
        text = f.read()
    if "Lemur_catta" in text or text.count("tree gen.") != 3 \
            or dit._last_runner.eng.n_tips != 11 \
            or sum("deleted" in ln for ln in dlines) != 1:
        raise AssertionError("the run after delete 2, or taxastat")
    for path in (f"{prefix}.cmp.pairs", f"{prefix}.cref.sdsf",
                 f"{workdir}/commref.txt"):
        if not os.path.getsize(path):
            raise AssertionError(f"{path} is empty")
    for phrase in ("lnLike trace", "Root-mean-square split frequency",
                   "Final ASDSF", "Moves that will be used"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"no {phrase!r} printed")
    out = {"commands": 14 + len(INFO_COMMANDS),
           "pruning_down_launches": launches, "gens": 500, "run_s": run_s}
    log(f"commands: {json.dumps(out)}; card {power_line}")
    return out


def phase_per_chain(torch, ds, power_line):
    """Phase 52: primates GTR+I+G, 1 run x 32 chains, with per-chain move
    selection: two timed blocks, the per-chain move counts against the
    move probabilities (chi-square p > 1e-3), one pruning.cu launch a
    generation, carried = recomputed, no host sync in a block; and the
    ms per generation without per-chain moves on the same engine
    settings."""
    from scipy.stats import chisquare

    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    ms = {}
    for per_chain in (True, False):
        eng = Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                     mcmc=McmcSettings(nruns=1, nchains=32, seed=3,
                                       per_chain_moves=per_chain),
                     device=DEV)
        states, bk = eng.init_chains()
        states, bk = eng.run_block(states, bk, 10)
        torch.cuda.synchronize()
        pruner = eng._pruners[0]
        pruner.launches = 0
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            states, bk = eng.run_block(states, bk, PER_CHAIN_GENS)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / PER_CHAIN_GENS)
        launches = pruner.launches
        ms[per_chain] = float(np.median(times))
        if not per_chain:
            break
        if launches != 2 * PER_CHAIN_GENS:
            raise AssertionError(f"per-chain: {launches} pruning.cu "
                                 f"launches for {2 * PER_CHAIN_GENS} gens")
        tries = bk["tries_total"].cpu().numpy()
        if not (tries.sum(1) == 10 + 2 * PER_CHAIN_GENS).all():
            raise AssertionError("a chain's move counts do not add up")
        counts = tries.sum(0)
        p = float(chisquare(counts, eng._move_probs.numpy()
                            * counts.sum()).pvalue)
        if p <= 1e-3:
            raise AssertionError(f"per-chain move counts: chi-square p {p}")
        assert_carried(eng, states, bk)
        torch.cuda.set_sync_debug_mode("error")
        try:
            states, bk = eng.run_block(states, bk, 10)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        probs = eng._move_probs.numpy()
        per = {"launches": launches, "gens": 2 * PER_CHAIN_GENS,
               "chi2_p": p, "moves": len(probs),
               # the distinct moves a generation's 32 draws hold on average
               "distinct_moves_per_gen": float(
                   (1.0 - (1.0 - probs) ** 32).sum())}
    out = {**per, "ms_per_gen_per_chain": ms[True],
           "ms_per_gen_shared": ms[False]}
    log(f"per-chain moves primates c32: {json.dumps(out)}; no host sync in "
        f"a 10-gen block; card {power_line}")
    return out


def phase_analyses(torch, ds, power_line):
    """Phases 47-52: the analyses group (``--phases analyses``)."""
    t0 = time.perf_counter()
    runs = {"report_replicase": phase_report_replicase(torch, power_line),
            "steppingstone": phase_steppingstone(torch, ds, power_line),
            **{f"start_{k}": v for k, v in
               phase_start_trees(torch, power_line).items()},
            "commands": phase_commands(torch, power_line),
            "per_chain": phase_per_chain(torch, ds, power_line),
            "report_primates": phase_report_primates(torch, ds, power_line)}
    log(f"analyses group {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# the best group (phases 53-55): BEST, the multispecies coalescent, on
# finch.nex with its 30 gene trees in one stacked.cu launch


def best_engine(torch, lines, nruns, nchains, device=None, seed=3):
    """A BEST engine built through the CLI on ``device`` (the card by
    default) from ``lines``
    (after which an mcmcp of ``nruns`` x ``nchains``)."""
    it, _ = cli_run([*lines, f"mcmcp nruns={nruns} nchains={nchains} "
                     f"seed={seed}"], device=device)
    return it.build_engine()


def best_kernel_case(torch, name, lines, C):
    """Phase 53's check at one engine's shape: the gene stack's operands
    at the engine's starting states (``Engine.gene_stack_operands``),
    stacked.cu with a tree a member against its plain version (every
    gene's per-pattern lnL, within RTOL/ATOL) and against each gene's own
    pruning.cu launch on the same operands; the CUDA-graph time of the one
    launch, of the G pruning.cu launches, the plain version's time, the
    bound and the plan."""
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    from mrbayes_tpu_torch.ops import stacked_cuda as SC
    eng = best_engine(torch, lines, 1, C)
    gs = eng._gene_stack
    if gs is None:
        raise AssertionError(f"{name}: no gene stack ({eng.notes})")
    lay = gs.layout
    states = eng.init_chains()[0]
    order, left, right, Pm, pi, _ = eng.gene_stack_operands(states)
    lr, pstep = gs.operands(order, left, right, Pm)
    root_k, ls_k = SC.stacked_down(lr, pstep, gs.tips, lay)
    torch.cuda.synchronize()
    root_p, ls_p = SC.stacked_down_plain(lr, pstep, gs.tips, lay)
    G, n_int = lay.D, lay.n_int
    singles, mine, plain, own = [], [], [], []
    for g in range(G):
        mine.append(site_lnl(torch, *lay.div_view(root_k, ls_k, g), pi[g]))
        plain.append(site_lnl(torch, *lay.div_view(root_p, ls_p, g), pi[g]))
        pst_g, tips_g = lay.div_operands(pstep, gs.tips, C, g)
        raw, _, root_g, ls_g = new_walk(torch, lr[g].contiguous(),
                                        pst_g.contiguous(),
                                        tips_g.contiguous())
        raw()
        singles.append(raw)
        own.append((root_g, ls_g))
    torch.cuda.synchronize()
    shape = (f"{name} G={G} n_tips={lay.n_tips} K={lay.ks[0]} "
             f"S={lay.ss[0]} P={min(lay.ps)}-{max(lay.ps)} "
             f"(sum {sum(lay.ps)}) C={C}")
    err = compare(torch, torch.cat([x.reshape(-1) for x in mine]),
                  torch.cat([x.reshape(-1) for x in plain]),
                  f"stacked_down with a tree a member, {shape}, vs plain")
    compare(torch, torch.cat([x.reshape(-1) for x in mine]),
            torch.cat([site_lnl(torch, r, l_, pi[g]).reshape(-1)
                       for g, (r, l_) in enumerate(own)]),
            f"stacked_down with a tree a member, {shape}, vs one "
            f"pruning.cu launch a gene")
    plan = lay.plan(C, lr.device)
    raw = group_walk(torch, lay, lr, pstep, gs.tips)[0]

    def per_gene():
        for fn in singles:
            fn()

    flops = 2 * C * n_int * 2 * sum(k * S * S * P for k, S, P in
                                    zip(lay.ks, lay.ss, lay.ps))
    nbytes = 4 * (lr.numel() + pstep.numel() + gs.tips.numel()
                  + root_k.numel() + ls_k.numel())
    rec = {"max_abs_err": err, "ms": time_graph(torch, raw),
           "loop_ms": time_events(torch, raw, 300),
           "pruning_down_per_gene_ms": time_graph(torch, per_gene, 20, 3),
           "plain_ms": time_events(
               torch, lambda: SC.stacked_down_plain(lr, pstep, gs.tips, lay),
               5),
           "operands_ms": time_events(
               torch, lambda: gs.operands(order, left, right, Pm), 100),
           **{k: v for k, v in bound(nbytes, flops).items()},
           "library_ms": None, "genes": G, "patterns": sum(lay.ps),
           "threads": plan["threads"], "T": sorted(set(plan["T"])),
           "lanes": sorted(set(plan["lanes"])),
           "smem_bytes": plan["smem_bytes"],
           "walks": sorted(set(plan["walks"])),
           "tiles": int(plan["tiles"].shape[0]), "shape": shape}
    log(f"stacked_down_gene_trees timing {shape}: {json.dumps(rec)}")
    return rec


def phase_best_kernels(torch):
    """Phase 53: stacked.cu with a tree a member at finch's 30 gene shapes
    (4 tips, S 4, K 1, 5-30 patterns) at C = 8 and 32 and at the two-gene
    primates shape, against its plain version and one pruning.cu launch a
    gene."""
    finch = [f"execute {FINCH}"]
    cases = {f"finch_c{C}": best_kernel_case(torch, "finch", finch, C)
             for C in BEST_KERNEL_CHAINS}
    cases["primates_2genes_c8"] = best_kernel_case(
        torch, "primates two genes", [f"execute {PRIMATES}",
                                      *PRIMATES_BEST], 8)
    return max(c["max_abs_err"] for c in cases.values()), cases


def phase_best_cli(torch, power_line):
    """Phase 54: finch through the CLI (the file's model; 2 runs x 4
    chains, ``BEST_GENS`` generations): exactly one stacked.cu launch a
    likelihood and no pruning.cu launch (the engine is built inside
    ``execute_file``: its counts start at 0 there and are read when the
    run is over), carried versus recomputed scores, the card against the
    port's CPU engine at the run's final state (each gene's lnL within
    FAMILY_LNL_TOL + OTHER_LNL_REL |lnL|), the species .t files with the 4
    species, the 30 gene-tree files a run, sump and sumt, gens/s and the
    CUDA kernels a generation."""
    from mrbayes_tpu_torch.envelope import run_batch
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    workdir = os.path.join(OUT, "finch")
    shutil.rmtree(workdir, ignore_errors=True)
    it, stats, lines = run_batch(
        "finch", workdir, BEST_GENS, device=DEV, samplefreq=BEST_SAMPLEFREQ,
        diagnfreq=BEST_GENS // 2, multiwalk=False, wavefront=False,
        stacked=False)
    runner = it._last_runner
    eng = runner.eng
    calls = BEST_GENS + 1
    stack = eng._gene_stack.launches
    pd = sum(p.launches for p in eng._pruners)
    if stack != calls or pd:
        raise AssertionError(f"finch: {stack} stacked.cu launches "
                             f"(predicted {calls}), {pd} pruning.cu")
    assert_carried(eng, runner.final_states, runner.final_bk)
    for phrase in ("Average PSRF for parameter values",
                   "Credible sets of trees", "Consensus tree written to"):
        if not any(phrase in ln for ln in lines):
            raise AssertionError(f"sump/sumt printed no {phrase!r}")
    # the card against the CPU port at the run's final state
    final = {k: v for k, v in runner.final_states.items()
             if k not in SCORE_KEYS and not k.startswith("eig")}
    card = eng.division_lnls(eng.refresh_eigs(final)).cpu().numpy()
    cpu_eng = best_engine(torch, [f"execute {FINCH}"], 2, 4, device="cpu")
    cpu = cpu_eng.division_lnls(cpu_eng.refresh_eigs(
        {k: v.cpu() for k, v in final.items()})).numpy()
    diff = np.abs(card - cpu)
    tol = FAMILY_LNL_TOL + OTHER_LNL_REL * np.abs(cpu)
    if not (diff <= tol).all():
        raise AssertionError(f"finch card vs CPU: max |dlnL| {diff.max()}")
    prefix = os.path.join(workdir, "finch")
    expect_rows = BEST_GENS // BEST_SAMPLEFREQ + 1
    for r in (1, 2):
        paths = [f"{prefix}.run{r}.t"] + [f"{prefix}.run{r}.gene{g}.t"
                                          for g in range(1, eng.n_div + 1)]
        if len(paths) != 31:
            raise AssertionError(f"finch: {eng.n_div} genes")
        for path in paths:
            with open(path) as f:
                text = f.read()
            if text.count("tree gen.") != expect_rows \
                    or not text.rstrip().endswith("end;"):
                raise AssertionError(f"{path}: incomplete")
        with open(paths[0]) as f:
            head = f.read().split("tree gen.")[0]
        if not all(f" {sp}" in head for sp in ("SpQ", "SpW", "SpB", "SpO")):
            raise AssertionError(f"{paths[0]}: translate block {head!r}")
    states, bk = runner.final_states, runner.final_bk
    n_k = cuda_kernels_during(torch, lambda: eng.run_block(states, bk, 20))
    out = {**stats, "stacked_launches": stack, "pruning_down_launches": pd,
           "launches_per_gen": stack / calls,
           "cuda_kernels_per_gen": None if n_k is None else n_k / 20,
           "card_vs_cpu_max_abs": float(diff.max()),
           "notes": eng.notes, "genes": eng.n_div}
    log(f"finch through the CLI, 2 runs x 4 chains, {BEST_GENS} gens: "
        f"{json.dumps(out)}; card {power_line}")
    log("\n".join(ln for ln in lines if "PSRF" in ln or "Credible" in ln
                  or "Consensus" in ln or "BEST" in ln))
    return it, out


def phase_best(torch, power_line):
    """Phases 53-55: the best group (``--phases best``): the gene-stack
    kernel, finch through the CLI and (55) a block and one generation of
    every BEST move type with host synchronisation made an error."""
    t0 = time.perf_counter()
    err, cases = phase_best_kernels(torch)
    it, run = phase_best_cli(torch, power_line)
    eng = it.build_engine()
    s, bk = eng.init_chains()
    sync_checked(torch, eng, s, bk, BEST_SYNC_GENS)
    log(f"finch: no host sync in a {BEST_SYNC_GENS}-gen block or in any of "
        f"the {len(eng.moves)} move types "
        f"({', '.join(m.name for m in eng.moves)})")
    log(f"best group {time.perf_counter() - t0:.1f} s")
    return err, cases, run


def primates_engine(torch, ds, nruns, nchains, device=DEV):
    from mrbayes_tpu_torch.mcmc.engine import Engine
    from mrbayes_tpu_torch.mcmc.settings import (DivisionSettings,
                                                 McmcSettings)
    return Engine(ds, [DivisionSettings(nst="6", rates="invgamma")],
                  mcmc=McmcSettings(nruns=nruns, nchains=nchains, seed=3),
                  device=device)


def carried_error(eng, states):
    """The largest |carried - recomputed| / (1e-3 + 1e-6 |recomputed|) of
    lnL, lnP_tree and lnP_par over every chain the engine holds, the
    recompute from fresh eigensystems (``assert_carried``'s bound is 1)."""
    from mrbayes_tpu_torch.mcmc.engine import SCORE_KEYS
    fresh = eng.score(eng.refresh_eigs(
        {k: v for k, v in states.items()
         if k not in SCORE_KEYS and not k.startswith("eig")}))
    return max(float(((states[k] - fresh[k]).abs()
                      / (1e-3 + 1e-6 * fresh[k].abs())).max())
               for k in ("lnL", "lnP_tree", "lnP_par"))


def rank_library(torch, rank, world, port):
    """Phase 56 on one rank: primates GTR+I+G in each layout of
    MULTIPROC_LAYOUTS through Engine, init_chains, shard_chains and
    run_block, each block followed by the runner's one gather
    (gather_to_host) and the bookkeeping put back on the card.  Returns the
    rank's record: the backend, and for each layout the gathered starting
    lnL, pruning.cu's launches over the timed blocks, gens/s a block, the
    collectives of each block and of each gather, the gathered temp_id
    and swap matrices and the card's temp_id after each block, carried
    against recomputed on every chain of the rank and the sync check (a
    run a rank)."""
    from mrbayes_tpu_torch.parallel import mesh as PM
    t_init = time.perf_counter()
    w = PM.init_distributed(f"127.0.0.1:{port}", world, rank, device=DEV,
                            timeout=MULTIPROC_DIST_TIMEOUT)
    ds = primates_dataset()
    out = {"rank": rank, "backend": w.backend, "device": str(w.device),
           "seconds": {"init": time.perf_counter() - t_init}}
    for name, (nruns, nchains) in MULTIPROC_LAYOUTS.items():
        t_layout = time.perf_counter()
        eng = primates_engine(torch, ds, nruns, nchains, device=w.device)
        C = eng.mcmc.n_chains_total
        states, bk = PM.shard_chains(eng, PM.auto_mesh(C), *eng.init_chains())
        host, _, _ = PM.gather_to_host(states, bk)
        rec = {"slice": list(eng.chain_slice),
               "start_lnL": host["lnL"].tolist()}
        sec = out["seconds"][name] = {"setup": time.perf_counter()
                                      - t_layout}

        def block(states, bk, n):
            c0 = w.collectives
            states, bk = eng.run_block(states, bk, n)
            c1 = w.collectives
            host, hbk, _ = PM.gather_to_host(states, bk)
            bk = PM.replicate_bookkeeping(bk, hbk, host["temp_id"])
            return states, bk, host, hbk, c1 - c0, w.collectives - c1

        t1 = time.perf_counter()
        states, bk, *_ = block(states, bk, MULTIPROC_WARM)
        torch.cuda.synchronize()
        sec["warm"] = time.perf_counter() - t1
        pruner = eng._pruners[0]
        pruner.launches = 0                  # the main path's run starts
        rates, blocks = [], []
        for _ in range(MULTIPROC_BLOCKS):
            t0 = time.perf_counter()
            states, bk, host, hbk, n_run, n_gather = block(
                states, bk, MULTIPROC_GENS)
            torch.cuda.synchronize()
            rates.append(MULTIPROC_GENS / (time.perf_counter() - t0))
            blocks.append({"temp_id": host["temp_id"].tolist(),
                           "card_temp_id": bk["temp_id"].tolist(),
                           "swap_tries": hbk["swap_tries"].tolist(),
                           "swap_accepts": hbk["swap_accepts"].tolist(),
                           "block_collectives": n_run,
                           "gather_collectives": n_gather})
        rec["launches"] = pruner.launches    # ... and ends here
        t1 = time.perf_counter()
        rec.update(gens_per_s_blocks=rates, blocks=blocks,
                   carried_error=carried_error(eng, states),
                   max_lnL=float(host["lnL"].max()))
        local = C // world % nchains == 0
        if local:
            # whole runs a rank: a block with host synchronisation an error
            torch.cuda.set_sync_debug_mode("error")
            try:
                states, bk = eng.run_block(states, bk, MULTIPROC_SYNC_GENS)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            rec["sync_checked_gens"] = MULTIPROC_SYNC_GENS
        sec["checks"] = time.perf_counter() - t1
        sec["total"] = time.perf_counter() - t_layout
        out[name] = rec
    PM.shutdown_distributed()
    return out


def rank_cli(torch, rank, world, port, workdir, script):
    """Phase 57 on one rank: the CLI's main with --coordinator, --nprocs
    and --procid (what ``python -m mrbayes_tpu_torch.cli`` runs) on
    ``script`` in ``workdir``; returns the run's generations, gens/s and
    pruning.cu launches (its engine is built inside the run: its count
    starts at 0 there and is read when the run is over)."""
    from mrbayes_tpu_torch import cli
    from mrbayes_tpu_torch.mcmc import run as R
    runners = []
    run = R.McmcRunner.run

    def recorded(self):
        runners.append(self)
        return run(self)

    R.McmcRunner.run = recorded
    os.chdir(workdir)
    rc = cli.main(["--coordinator", f"127.0.0.1:{port}", "--nprocs",
                   str(world), "--procid", str(rank), "--device", DEV,
                   script])
    r = runners[0]
    return {"rank": rank, "rc": rc, "generations": r.generations,
            "gens_per_s": r.generations / r.wall_seconds,
            "launches": sum(p.launches for p in r.eng._pruners)}


def rank_worker(torch, argv):
    """``--worker RANK WORLD LIBRARY_PORT CLI_PORT WORKDIR SCRIPT``: one
    rank of the multiproc group, the library phase and then the CLI phase
    (one process start for both), begun (``main``: before it imports
    torch) when the parent writes a line to its standard input, so that
    no rank's start overlaps the parent's one-process runs; prints its
    records as a ``RANK_RESULT`` JSON line."""
    rank, world = int(argv[0]), int(argv[1])
    started = time.time()
    t0 = time.perf_counter()
    lib = rank_library(torch, rank, world, argv[2])
    t1 = time.perf_counter()
    cli = rank_cli(torch, rank, world, argv[3], argv[4], argv[5])
    print("RANK_RESULT " + json.dumps({
        "library": lib, "cli": cli,
        "seconds": {"started": started, "library": t1 - t0,
                    "cli": time.perf_counter() - t1}}), flush=True)
    return 0


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(arg_lists, cwds):
    """Start one ``--worker`` process a rank (the kernels are built
    already); each waits for its go line (``finish_ranks``)."""
    env = {**os.environ, "MB_DIST_TIMEOUT": str(MULTIPROC_DIST_TIMEOUT)}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         *map(str, args)], cwd=cwd, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for args, cwd in zip(arg_lists, cwds)]


def kill_ranks(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_ranks(procs):
    """Send every rank its go line, wait for all under MULTIPROC_TIMEOUT
    s, kill every one on overrun, and fail unless each exits 0 with its
    record; returns [(record, output)]."""
    go = time.time()
    deadline = time.monotonic() + MULTIPROC_TIMEOUT
    outs = []
    try:
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        kill_ranks(procs)
    res = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        recs = [ln[len("RANK_RESULT "):] for ln in out.splitlines()
                if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not recs:
            raise AssertionError(f"rank {i} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
        rec = json.loads(recs[-1])
        sec = rec["seconds"]
        sec["started"] -= go
        log(f"rank {i}: started {sec['started']:.1f} s after its go line "
            f"(imports, the card), library {sec['library']:.1f} s "
            f"{json.dumps(rec['library']['seconds'])}, CLI "
            f"{sec['cli']:.1f} s")
        res.append((rec, out))
    return res


def one_process_rates(torch, ds, nruns, nchains):
    """The same configuration in one process on the card: the starting
    lnL and gens/s over the same blocks, each followed by its one
    device->host copy, as the runner makes it."""
    from mrbayes_tpu_torch.mcmc.run import host_states
    eng = primates_engine(torch, ds, nruns, nchains)
    states, bk = eng.init_chains()
    start = states["lnL"].tolist()
    states, bk = eng.run_block(states, bk, MULTIPROC_WARM)
    host_states(states, bk)
    rates = []
    for _ in range(MULTIPROC_BLOCKS):
        t0 = time.perf_counter()
        states, bk = eng.run_block(states, bk, MULTIPROC_GENS)
        host_states(states, bk)
        rates.append(MULTIPROC_GENS / (time.perf_counter() - t0))
    return start, rates


def check_multiproc_library(torch, ranks, one, power_line):
    """Phase 56's checks on the two ranks' library records against one
    process on the card (``one``: each layout's starting lnL and gens/s).
    Fatal unless: the backend is the rule's (gloo: the ranks share a
    card); each rank's pruning.cu launches equal one a generation of the
    timed blocks; the gathered starting lnL equals the one-process
    engine's within 2e-5 |lnL| (both score all chains in one launch);
    carried equals recomputed on every chain of every rank; after every
    block the gathered temp_id and swap matrices and the card's temp_id
    are the same on both ranks and each run's temp_id is a permutation; a
    run a rank makes no collective in a block and passes a block with
    host synchronisation an error; one run over both ranks makes one
    collective (the gather of E) a swap generation.  Prints each rank's
    gens/s beside the one-process gens/s."""
    from mrbayes_tpu_torch.parallel.mesh import choose_backend
    backend = choose_backend(torch.device(DEV, 0), 2)
    out = {"backend": backend, "layouts": {}}
    for name, (nruns, nchains) in MULTIPROC_LAYOUTS.items():
        start, one_rates = one[name]
        C, per = nruns * nchains, nruns * nchains // 2
        local = per % nchains == 0
        recs = [r[name] for r in ranks]
        for r, rec in zip(ranks, recs):
            if r["backend"] != backend:
                raise AssertionError(f"rank {r['rank']}: backend "
                                     f"{r['backend']}, the rule says "
                                     f"{backend}")
            want = MULTIPROC_BLOCKS * MULTIPROC_GENS
            if rec["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: "
                                     f"{rec['launches']} pruning.cu "
                                     f"launches, predicted {want}")
            diff = np.abs(np.asarray(rec["start_lnL"]) - start)
            if not (diff <= 2e-5 * np.abs(start)).all():
                raise AssertionError(f"{name} rank {r['rank']}: starting "
                                     f"lnL differs by {diff.max()}")
            if rec["carried_error"] > 1.0:
                raise AssertionError(f"{name} rank {r['rank']}: carried "
                                     f"vs recomputed {rec['carried_error']}")
            for b in rec["blocks"]:
                want_coll = 0 if local else MULTIPROC_GENS
                if b["block_collectives"] != want_coll \
                        or b["gather_collectives"] != 1:
                    raise AssertionError(
                        f"{name} rank {r['rank']}: {b['block_collectives']}"
                        f" collectives in a block (predicted {want_coll}), "
                        f"{b['gather_collectives']} a gather")
                tid = np.asarray(b["temp_id"]).reshape(nruns, nchains)
                if not (np.sort(tid, 1) == np.arange(nchains)).all() \
                        or b["card_temp_id"] != b["temp_id"]:
                    raise AssertionError(f"{name}: temp_id {tid}")
            if local and rec.get("sync_checked_gens") != MULTIPROC_SYNC_GENS:
                raise AssertionError(f"{name}: no sync check")
        if recs[0]["blocks"] != recs[1]["blocks"] \
                or recs[0]["start_lnL"] != recs[1]["start_lnL"]:
            raise AssertionError(f"{name}: the ranks' gathered views differ")
        if [r["slice"] for r in recs] != [[0, per], [per, C]]:
            raise AssertionError(f"{name}: slices "
                                 f"{[r['slice'] for r in recs]}")
        lay = {
            "runs_x_chains": f"{nruns}x{nchains}", "chains_a_rank": per,
            "swap": "local" if local else "gathered",
            "gens_per_s_ranks": [float(np.median(r["gens_per_s_blocks"]))
                                 for r in recs],
            "gens_per_s_blocks_ranks": [r["gens_per_s_blocks"] for r in recs],
            "gens_per_s_one_process": float(np.median(one_rates)),
            "gens_per_s_one_process_blocks": one_rates,
            "launches_ranks": [r["launches"] for r in recs],
            "gens": MULTIPROC_BLOCKS * MULTIPROC_GENS,
            "collectives_per_block": recs[0]["blocks"][0][
                "block_collectives"] + 1,
            "start_lnl_exact": bool(recs[0]["start_lnL"] == start),
            "carried_error_max": max(r["carried_error"] for r in recs),
            "max_lnL": max(r["max_lnL"] for r in recs),
            "sync_checked": local}
        out["layouts"][name] = lay
        log(f"multiproc library {name} ({lay['runs_x_chains']}, {per} "
            f"chains a rank, swaps {lay['swap']}, backend {backend}): "
            f"gens/s ranks {lay['gens_per_s_ranks']} vs one process "
            f"{lay['gens_per_s_one_process']:.1f}; collectives a block "
            f"{lay['collectives_per_block']}; pruning.cu launches "
            f"{lay['launches_ranks']} for {lay['gens']} gens a rank; card "
            f"{power_line}")
    return out


def check_multiproc_cli(ranks, outs, one, dirs, power_line):
    """Phase 57's checks on tests/test_multihost.py's DRIVE script at
    MULTIPROC_CLI_GENS generations through the CLI on two ranks sharing
    the card, rank 1 working in a directory of its own.  Fatal unless:
    both exit 0; rank 0 writes dist.run1.p, run2.p, run1.t, run2.t, ckp,
    mcmc, con.tre, pstat and trprobs and sump and sumt run (its output
    logs the sharding, the consensus and the PSRF table); rank 1's
    directory stays empty and its output has no "Consensus"; each rank's
    pruning.cu launches equal one a generation plus the starting scores.
    The gens/s of both ranks beside the same script's in one process
    (``one``, its runner)."""
    (r0, r1), (out0, out1) = ranks, outs
    for suffix in MULTIPROC_FILES:
        if not os.path.exists(os.path.join(dirs[0], f"dist.{suffix}")):
            raise AssertionError(f"rank 0 wrote no dist.{suffix}")
    if os.listdir(dirs[1]):
        raise AssertionError(f"rank 1 wrote {os.listdir(dirs[1])}")
    for phrase in ("Sharding over mesh {'chains': 2, 'sites': 1} "
                   "(2 process(es), backend", "Consensus tree written to",
                   "Average PSRF for parameter values"):
        if phrase not in out0:
            raise AssertionError(f"rank 0 printed no {phrase!r}")
    if "Consensus" in out1:
        raise AssertionError("rank 1 printed a consensus")
    want = MULTIPROC_CLI_GENS + 1
    for r in (r0, r1):
        if r["rc"] != 0 or r["generations"] != MULTIPROC_CLI_GENS \
                or r["launches"] != want:
            raise AssertionError(f"rank {r['rank']}: {r}, {want} launches "
                                 f"predicted")
    with open(os.path.join(dirs[0], "dist.run1.p")) as f:
        rows = sum(1 for ln in f if ln[:1].isdigit())
    out = {"gens": MULTIPROC_CLI_GENS,
           "gens_per_s_ranks": [r0["gens_per_s"], r1["gens_per_s"]],
           "gens_per_s_one_process": one.generations / one.wall_seconds,
           "launches_ranks": [r0["launches"], r1["launches"]],
           "launches_one_process": sum(p.launches
                                       for p in one.eng._pruners),
           "p_rows": rows, "files": list(MULTIPROC_FILES)}
    log(f"multiproc CLI, DRIVE at {MULTIPROC_CLI_GENS} gens, 2 runs x 2 "
        f"chains over 2 ranks: {json.dumps(out)}; card {power_line}")
    log("\n".join(ln for ln in out0.splitlines()
                  if "Sharding" in ln or "Process group" in ln
                  or "Time breakdown" in ln))
    return out


def phase_multiproc(torch, ds, power_line):
    """Phases 56-58, the multiproc group (``--phases multiproc``): the
    same work in one process on the card first (both library layouts and
    the DRIVE script through the CLI), then two ranks sharing the card,
    each started once for the library phase (56) and the CLI phase (57),
    and (58) their pruning.cu launches for the kernels line."""
    from mrbayes_tpu_torch.cli import Interpreter
    t0 = time.perf_counter()
    base = os.path.join(OUT, "multiproc")
    shutil.rmtree(base, ignore_errors=True)
    dirs = [os.path.join(base, d) for d in ("rank0", "rank1", "one")]
    for d in dirs:
        os.makedirs(d)
    script = os.path.join(base, "drive.nex")
    with open(script, "w") as f:
        f.write(MULTIPROC_DRIVE.format(primates=PRIMATES,
                                       ngen=MULTIPROC_CLI_GENS))
    ports = free_port(), free_port()
    procs = start_ranks([(i, 2, *ports, dirs[i], script)
                         for i in range(2)], dirs[:2])
    cwd = os.getcwd()
    try:
        one = {name: one_process_rates(torch, ds, *shape)
               for name, shape in MULTIPROC_LAYOUTS.items()}
        os.chdir(dirs[2])
        it = Interpreter(log=lambda msg: None, device=DEV)
        it.execute_file(script)
    except BaseException:
        kill_ranks(procs)
        raise
    finally:
        os.chdir(cwd)
    t1 = time.perf_counter()
    res = finish_ranks(procs)
    t2 = time.perf_counter()
    lib = check_multiproc_library(torch, [r["library"] for r, _ in res],
                                  one, power_line)
    cli = check_multiproc_cli([r["cli"] for r, _ in res],
                              [o for _, o in res], it._last_runner, dirs,
                              power_line)
    launches = {**{f"multiproc_library_{name}_rank{i}": n
                   for name, lay in lib["layouts"].items()
                   for i, n in enumerate(lay["launches_ranks"])},
                **{f"multiproc_cli_rank{i}": n
                   for i, n in enumerate(cli["launches_ranks"])}}
    gens = {**{f"multiproc_library_{name}_rank{i}": lay["gens"]
               for name, lay in lib["layouts"].items() for i in range(2)},
            **{f"multiproc_cli_rank{i}": cli["gens"] for i in range(2)}}
    out = {"library": lib, "cli": cli, "pruning_down_launches": launches,
           "gens_per_run": gens,
           "seconds": {"one_process": t1 - t0, "ranks": t2 - t1,
                       "ranks_each": [r["seconds"] for r, _ in res],
                       "total": time.perf_counter() - t0}}
    log(f"multiproc group: {json.dumps(out)}; card {power_line}")
    log(f"multiproc group {out['seconds']['total']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--test1-gens", type=int, default=TEST1_GENS)
    ap.add_argument("--primates-blocks", type=int, default=2)
    ap.add_argument("--cynmix-gens", type=int, default=CYNMIX_GENS)
    ap.add_argument("--switch-blocks", type=int, default=1,
                    help="blocks per setting in each switch timing")
    ap.add_argument("--phases", default="all",
                    help="comma-separated phase groups to run (default "
                         f"all): {', '.join(PHASE_GROUPS)}")
    ap.add_argument("--worker", nargs="+", default=None,
                    help="run one rank of a multiproc phase (the script "
                         "starts these itself)")
    args = ap.parse_args(argv)
    groups = (set(PHASE_GROUPS) if args.phases == "all"
              else set(args.phases.split(",")))
    if not groups <= set(PHASE_GROUPS):
        ap.error(f"unknown phase groups {sorted(groups - set(PHASE_GROUPS))}")
    if args.worker and not sys.stdin.readline():
        raise RuntimeError("the parent closed the ranks' go line unsent")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if args.worker:
        return rank_worker(torch, args.worker)
    from mrbayes_tpu_torch.ops import pruning_cuda as PC
    t_start = time.perf_counter()

    def done(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    power_line = nvidia_smi_line()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; phase groups {sorted(groups)}")
    log(power_line)

    # 2. build
    t0 = time.perf_counter()
    builds = PC.libraries(verbose=True)
    log(f"build: {len(builds)} libraries in {time.perf_counter() - t0:.2f} "
        f"s wall")
    ptxas = {}
    for nm, kb in builds.items():
        log(f"build {nm}: {kb.path} in {kb.seconds:.2f} s\n{kb.log.strip()}")
        ptxas[nm] = ptxas_summary(kb.log)
        for kname, regs, st, ld in ptxas[nm]:
            log(f"ptxas {nm}: {kname} {regs} registers, {st} B spill stores, "
                f"{ld} B spill loads")
    ds = primates_dataset()

    if "kernels" in groups:
        # 3. kernels
        err_pd, t_pd, pd_cases = phase_kernels(torch)
        err_mw, t_mw = phase_multiwalk_kernels(torch)
        err_wf, t_wf, wf_root_diff = phase_wavefront_kernels(torch)
        err_st, t_st = phase_stacked(torch)
        err_ck, t_ck = phase_clock_kernels(torch)
        eigh_cases = phase_eigh(torch)
        done("kernels phases")

    if "primates" in groups:
        # 4.-5. primates, the first slice's main path
        log(f"primates: {ds.ntax} taxa, {ds.divisions[0].npat} patterns")
        runs = {C: phase_primates(torch, ds, C, args.primates_blocks,
                                  power_line) for C in (4, 32)}
        phase_golden(torch, ds)
        done("primates phases")

    if "test1" in groups:
        # 6.-9. test1, the second slice's main path
        it, t1 = phase_test1(torch, args.test1_gens, power_line)
        switch = phase_switch(torch, it, args.switch_blocks, power_line)
        phase_golden_partitioned(torch)
        done("test1 phases")

    if "cynmix" in groups:
        # 10.-12. cynmix, the third slice's main path
        golden_cyn = phase_golden_cynmix(torch, [f"{DEV}:0"] * 4)
        it_c, cyn = phase_cynmix(torch, args.cynmix_gens, power_line)
        cswitch = phase_cynmix_switch(torch, it_c, args.switch_blocks,
                                      power_line)
        done("cynmix phases")

    if "sharded" in groups:
        # 13.-16. the sites mesh axis, the fourth slice's main path
        err_sh, t_sh, sh_cyn_shapes, sh_prim, sh_cyn, sh_dry, sh_cards = \
            phase_sharded(torch, ds, count, power_line)
        done("sharded phases")

    if "clock" in groups:
        # 17.-20. clock trees and test2, the seventh slice's main path
        golden_clock, golden_clock_launches = phase_golden_clock(torch, ds)
        it2, t2 = phase_test1(torch, TEST2_GENS, power_line, name="test2")
        switch2 = phase_switch(torch, it2, args.switch_blocks, power_line,
                               name="test2")
        prior = [phase_prior_only(torch, ds, seed, power_line)
                 for seed in PRIOR_SEEDS]
        done("clock phases")

    if "aa_codon" in groups:
        # 21.-26. the amino-acid and codon models, the eighth slice's main
        # path
        golden_aa, golden_aa_launches = phase_golden_aa_codon(torch)
        done("golden protein and codon rows")
        _, avian = phase_aa_codon_cli(torch, "avian", AA_GENS, False,
                                      power_line)
        done("avian")
        _, gtr_eng = aa_codon_engine(torch, AVIAN,
                                     ["prset aamodelpr=fixed(gtr)"],
                                     nchains=4)
        gtr_sync = phase_aa_codon_sync(torch, "avian aamodelpr=fixed(gtr)",
                                       gtr_eng, power_line)
        _, mixed_eng = aa_codon_engine(torch, AVIAN,
                                       ["prset aamodelpr=mixed"], nchains=4)
        mixed_sync = phase_aa_codon_sync(torch, "avian aamodelpr=mixed",
                                         mixed_eng, power_line, solver=False)
        done("avian sync checks")
        it_r, ny98 = phase_aa_codon_cli(torch, "replicase_ny98", CODON_GENS,
                                        True, power_line)
        ny98_sync = phase_aa_codon_sync(torch, "replicase NY98",
                                        it_r.build_engine(), power_line)
        done("replicase NY98")
        aa_prior = phase_aa_codon_prior(torch, AA_PRIOR_SEED, power_line)
        done("protein and codon phases")

    if "dating" in groups:
        # 27.-31. dating and hymfossil, the tenth slice's main path
        err_hym, hym_cases = phase_hymfossil_kernels(torch)
        golden_hym, golden_hym_spread, golden_hym_launches = \
            phase_golden_hymfossil(torch)
        it_h, hym = phase_hymfossil_cli(torch, HYM_GENS, power_line)
        dating_sync = phase_dating_sync(torch, it_h, power_line)
        dating_prior = phase_dating_prior(torch, power_line)
        done("dating phases")

    if "kim_codon" in groups:
        # 32.-37. doublets, codon M3 and M10, and unlinked trees, the
        # eleventh slice's main paths
        err_kc, kc_cases = phase_kim_codon_kernels(torch)
        kc_eigh = phase_kim_codon_eigh(torch)
        done("doublet and M3/M10 kernel phases")
        golden_kc, golden_kc_launches = phase_golden_kim_codon(torch)
        done("golden kim and M10 rows")
        it_k, kim = phase_kim_codon_cli(torch, "kim_doublet", KIM_GENS,
                                        power_line)
        kim["sync_eigh_launches"] = phase_aa_codon_sync(
            torch, "kim stem doublets", it_k.build_engine(), power_line)
        done("kim stem doublets")
        it_m, m10 = phase_kim_codon_cli(torch, "replicase_m10", M10_GENS,
                                        power_line)
        m10["sync_eigh_launches"] = phase_aa_codon_sync(
            torch, "replicase M10", it_m.build_engine(), power_line)
        it_3, m3 = phase_kim_codon_cli(torch, "replicase_m3", M3_GENS,
                                       power_line)
        m3["sync_eigh_launches"] = phase_aa_codon_sync(
            torch, "replicase M3", it_3.build_engine(), power_line)
        done("replicase M10 and M3")
        it_u, unl = phase_kim_codon_cli(torch, "kim_unlinked", UNLINKED_GENS,
                                        power_line)
        unl.update(phase_unlinked_lnl(torch, it_u._last_runner.eng,
                                      it_u._last_runner.final_states,
                                      power_line))
        eng_u = it_u.build_engine()
        unl["sync_eigh_launches"] = phase_aa_codon_sync(
            torch, "kim unlinked trees", eng_u, power_line,
            solver=solver_divisions(eng_u))
        done("kim unlinked trees")

    if "covarion" in groups:
        # 38.-41. covarion, restriction data and directional root
        # frequencies, the thirteenth slice's main paths
        err_cv, cv_cases, cv_eigh, golden_cv, golden_cv_launches, cv_runs = \
            phase_covarion(torch, power_line)
        done("covarion and restriction phases")

    if "families" in groups:
        # 42.-46. lnorm, kmixture and adgamma rates, symdirihyperpr,
        # parsmodel and continuous data, the fourteenth slice's main paths
        err_fam, fam_cases, fam_states, fam_mw, fam_runs = phase_families(
            torch, power_line)
        done("families phases")

    if "analyses" in groups:
        # 47.-52. report, steppingstone, built starting trees, the
        # commands and per-chain moves, the fifteenth slice's main paths
        ana = phase_analyses(torch, ds, power_line)
        done("analyses phases")

    if "best" in groups:
        # 53.-55. BEST on finch, the sixteenth slice's main path
        err_best, best_cases, best_run = phase_best(torch, power_line)
        done("best phases")

    if "multiproc" in groups:
        # 56.-58. the chains axis over two ranks sharing the card, the
        # seventeenth slice's main path
        multiproc = phase_multiproc(torch, ds, power_line)
        done("multiproc phases")

    if groups != set(PHASE_GROUPS):
        # a chosen subset: every kernel named, its numbers in the groups'
        # own lines above
        log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
        log(power_line)
        print(json.dumps({"kernels": [
            {**k, **dict.fromkeys(KERNEL_NUMBERS), "phases": sorted(groups)}
            for k in KERNEL_IDS]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": name,
                                                 "count": count}}),
              flush=True)
        return 0

    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")
    # each kernel's launches are the sum of its runs' counts, each count
    # set to 0 just before its run and read just after
    pd_launches = {
        **{f"primates_c{C}": r["launches"] for C, r in runs.items()},
        "test1_switch_off": switch["pruning_down_launches_off"],
        "test2_switch_off": switch2["pruning_down_launches_off"],
        "golden_clock_rows": golden_clock_launches,
        "golden_protein_codon_rows": golden_aa_launches["pruning_down"],
        "avian_cli": avian["pruning_down_launches"],
        "replicase_ny98_cli": ny98["pruning_down_launches"],
        "golden_hymfossil_rows": golden_hym_launches,
        "hymfossil_cli": hym["launches"],
        "golden_kim_codon_rows": golden_kc_launches["pruning_down"],
        "kim_doublet_cli": kim["launches"],
        "replicase_m10_cli": m10["launches"],
        "replicase_m3_cli": m3["launches"],
        "kim_unlinked_cli": unl["launches"],
        "golden_covarion_rows": golden_cv_launches,
        **{f"{nm}_cli": r["launches"] for nm, r in cv_runs.items()},
        **{f"{nm}_cli": r["pruning_down_launches"]
           for nm, r in fam_runs.items()},
        **{f"analyses_{nm}": r["pruning_down_launches"]
           for nm, r in ana.items() if nm != "per_chain"},
        "analyses_per_chain": ana["per_chain"]["launches"],
        **multiproc["pruning_down_launches"]}
    eigh_launches = {"golden_codon_rows": golden_aa_launches["eigh"],
                     "avian_cli": avian["eigh_launches"],
                     "avian_gtr_sync": gtr_sync,
                     "avian_mixed_sync": mixed_sync,
                     "replicase_ny98_cli": ny98["eigh_launches"],
                     "replicase_ny98_sync": ny98_sync,
                     "golden_kim_codon_rows": golden_kc_launches["eigh"],
                     **{f"{nm}_{what}": r[f"{key}eigh_launches"]
                        for nm, r in (("kim_doublet", kim),
                                      ("replicase_m10", m10),
                                      ("replicase_m3", m3),
                                      ("kim_unlinked", unl))
                        for what, key in (("cli", ""), ("sync", "sync_"))},
                     "avian_covarion_cli": cv_runs["avian_covarion"][
                         "eigh_launches"],
                     "avian_covarion_sync": cv_runs["avian_covarion"][
                         "sync_eigh_launches"]}
    aa_keys = ("best_lnl", "tl_mean", "asdsf", "avg_psrf", "run_s",
               "gens_per_s")
    mw_launches = {"test1": t1["multiwalk_launches"],
                   "test2": t2["multiwalk_launches"],
                   "primates_lnorm_kmix_cli": fam_runs[
                       "primates_lnorm_kmix"]["multiwalk_launches"]}
    kernels = [{
        **KERNEL_IDS[0],
        "launches": sum(pd_launches.values()),
        "launches_per_run": pd_launches,
        "gens_per_run": {
            **{f"primates_c{C}": r["gens"] for C, r in runs.items()},
            "test1_switch_off": args.switch_blocks * BLOCK_GENS,
            "test2_switch_off": args.switch_blocks * BLOCK_GENS,
            "avian_cli": AA_GENS, "replicase_ny98_cli": CODON_GENS,
            "hymfossil_cli": HYM_GENS, "kim_doublet_cli": KIM_GENS,
            "replicase_m10_cli": M10_GENS, "replicase_m3_cli": M3_GENS,
            "kim_unlinked_cli": UNLINKED_GENS,
            **{f"{nm}_cli": g for nm, (_, g) in COVARION_CLI.items()},
            **{f"{nm}_cli": FAMILY_GENS for nm in FAMILY_CLI},
            **{f"analyses_{nm}": r["gens"] for nm, r in ana.items()},
            **multiproc["gens_per_run"]},
        "max_abs_err": max(err_pd, err_ck["pruning_down"], err_hym, err_kc,
                           err_cv, err_fam),
        **{k: t_pd[4][k] for k in keys + ("before_ms", "walk", "threads",
                                           "T", "lanes")},
        "library_ms": None,
        "shape": "primates n_tips=12 P=413 K=4 S=4 C=4",
        "c32": {k: t_pd[32][k] for k in keys + ("before_ms", "walk",
                                                 "threads", "T", "lanes")},
        "cases": pd_cases,
        "clock_cases": t_ck["pruning_down"],
        "hymfossil_cases": hym_cases,
        "hymfossil": {k: hym[k] for k in (
            "best_lnl", "tl_mean", "asdsf", "avg_psrf", "run_s",
            "gens_per_s", "launches_per_gen", "sampled_ancestors_max",
            "sampled_ancestors_mean_per_run")},
        "golden_hymfossil_max_err": golden_hym,
        "golden_hymfossil_path_spread": golden_hym_spread,
        "dating_sync_moves": dating_sync,
        "dating_prior_only": dating_prior,
        "kim_codon_cases": kc_cases,
        **{nm: {k: r[k] for k in (
            "best_lnl", "tl_mean", "asdsf", "avg_psrf", "run_s",
            "gens_per_s", "launches_per_gen", "eigh_launches", "n_div",
            "n_trees")} for nm, r in (("kim_doublet", kim),
                                      ("replicase_m10", m10),
                                      ("replicase_m3", m3),
                                      ("kim_unlinked", unl))},
        "kim_unlinked_lnl": {k: unl[k] for k in (
            "division_kernel_vs_plain", "total_vs_sum")},
        "golden_kim_codon_max_err": golden_kc,
        "covarion_cases": cv_cases,
        **{nm: {k: r[k] for k in (
            "best_lnl", "tl_mean", "asdsf", "avg_psrf", "run_s", "gens_per_s",
            "launches_per_gen", "eigh_launches", "nruns", "rooted_trees")}
           for nm, r in cv_runs.items()},
        "golden_covarion_max_err": golden_cv,
        "analyses": ana,
        "multiproc": {k: multiproc[k] for k in ("library", "cli")},
        "families_cases": fam_cases,
        "families_identical_states": fam_states,
        **{nm: {k: r[k] for k in (
            "best_lnl", "tl_mean", "asdsf", "avg_psrf", "run_s", "gens_per_s",
            "launches_per_gen", "nruns")} for nm, r in fam_runs.items()},
        "gens_per_s": {f"primates_c{C}": r["gens_per_s"]
                       for C, r in runs.items()},
        "gens_per_s_blocks": {f"primates_c{C}": r["gens_per_s_blocks"]
                              for C, r in runs.items()},
        "card": power_line,
    }, {
        **KERNEL_IDS[1],
        "launches": sum(mw_launches.values()),
        "launches_per_run": mw_launches,
        "gens_per_run": {"test1": args.test1_gens, "test2": TEST2_GENS,
                         "primates_lnorm_kmix_cli": FAMILY_GENS},
        "max_abs_err": max(err_mw, err_ck["multiwalk_down"],
                           fam_mw["max_abs_err"]),
        **{k: t_mw[8][k] for k in keys + (
            "loop_ms", "before_ms", "stacked_same_work_ms",
            "pruning_down_per_division_ms",
            "pruning_down_per_division_loop_ms", "walks", "threads", "T",
            "lanes", "smem_bytes")},
        "library_ms": None,
        "shape": "test1 D=2 n_tips=12 P=199,258 K=4 S=4 C=8",
        "c32": {k: t_mw[32][k] for k in keys + (
            "loop_ms", "before_ms", "stacked_same_work_ms",
            "pruning_down_per_division_ms", "walks", "threads", "T",
            "lanes")},
        "ptxas": ptxas["multiwalk"],
        "test1": {k: t1[k] for k in ("best_lnl", "tl_mean", "asdsf",
                                     "avg_psrf", "run_s", "gens_per_s")},
        "test1_gens_per_s_switch": {"off": switch["off"],
                                    "on": switch["on"]},
        "clock_cases": t_ck["multiwalk_down"],
        "test2": {k: t2[k] for k in ("best_lnl", "tl_mean", "asdsf",
                                     "avg_psrf", "run_s", "gens_per_s")},
        "test2_gens_per_s_switch": {"off": switch2["off"],
                                    "on": switch2["on"]},
        "golden_clock_max_err": golden_clock,
        "prior_only": prior,
        "lnorm_kmixture_group": fam_mw,
        "card": power_line,
    }, {
        **KERNEL_IDS[2],
        "launches": cyn["wavefront_launches"],
        "gens": args.cynmix_gens,
        "max_abs_err": err_wf,
        "root_vs_pruning_max_abs": wf_root_diff,
        **{k: t_wf[537][k] for k in keys + (
            "loop_ms", "before_ms", "pruning_down_same_work_ms",
            "pruning_down_same_work_loop_ms", "schedule_and_operands_ms",
            "pruning_operands_ms", "rows_mean", "n_int", "walk", "threads",
            "groups", "T", "lanes", "smem_bytes")},
        "library_ms": None,
        "shape": "cynmix COI n_tips=32 P=537 K=4 S=4 W=8 C=8",
        "cynmix_shapes": {P if isinstance(P, str) else f"P={P}":
                          {k: v for k, v in t.items()
                           if k not in ("bytes", "flops")}
                          for P, t in t_wf.items()},
        "ptxas": ptxas["wavefront"],
        "cynmix": {k: cyn[k] for k in ("best_lnl", "tl_mean", "asdsf",
                                       "avg_psrf", "run_s", "gens_per_s")},
        "cynmix_gens_per_s_switches": {"off": cswitch["off"],
                                       "on": cswitch["on"]},
        "golden_cynmix_max_err": golden_cyn[0],
        "card": power_line,
    }, {
        **KERNEL_IDS[3],
        "launches": cyn["stacked_launches"],
        "gens": args.cynmix_gens,
        "max_abs_err": err_st,
        **{k: t_st[k] for k in ("ms", "before_ms", "plain_ms", "bound_ms",
                                "bound_by", "operands_ms",
                                "pruning_down_per_division_ms",
                                "per_division_operands_ms", "threads", "T",
                                "lanes", "smem_bytes", "mixed_walks",
                                "walks", "tiles")},
        "library_ms": None,
        "shape": "cynmix divisions 0,1,2,3,5 stacked: n_tips=32 (K, S, P) = "
                 "(4,2,124) (4,3,34) (4,4,10) (4,8,9) (4,4,125), C=8",
        "card": power_line,
    }, {
        **KERNEL_IDS[4],
        "launches": sh_prim["launches"] + sh_cyn["launches"],
        "launches_per_run": {"primates_c4": sh_prim["launches"],
                             "cynmix": sh_cyn["launches"],
                             "cynmix_dummy_passes": sh_cyn["dummy_launches"]},
        "gens_per_run": {"primates_c4": sh_prim["gens"],
                         "cynmix": sh_cyn["gens"]},
        "shards": 4,
        "devices": sh_prim["devices"],
        "max_abs_err": err_sh,
        **{k: t_sh[(4, 4)][k] for k in ("ms", "per_shard_ms",
                                        "per_shard_before_ms", "walk",
                                        "wrapper_ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "padded_patterns")},
        "library_ms": None,
        "shape": "primates n_tips=12 P=413 (416 padded) K=4 S=4 C=4 over 4 "
                 "shards of one card",
        "by_shape": {f"c{C}_k{k}": {key: v for key, v in t.items()
                                    if key not in ("bytes", "flops")}
                     for (C, k), t in t_sh.items()},
        "cynmix_shapes_k4": sh_cyn_shapes,
        "primates": {k: sh_prim[k] for k in (
            "gens_per_s", "gens_per_s_unsharded", "launches_per_gen",
            "lnl_diff_identical_states")},
        "cynmix": {k: sh_cyn[k] for k in (
            "gens_per_s", "gens_per_s_unsharded", "launches_per_gen",
            "max_division_lnl_diff")},
        "golden_cynmix_max_err": golden_cyn[0],
        "dryrun_sites": sh_dry,
        "distinct_cards": sh_cards or None,
        "card": power_line,
    }, {
        **KERNEL_IDS[5],
        "launches": sum(eigh_launches.values()),
        "launches_per_run": eigh_launches,
        "gens_per_run": {"avian_cli": AA_GENS,
                         "replicase_ny98_cli": CODON_GENS,
                         "kim_doublet_cli": KIM_GENS,
                         "replicase_m10_cli": M10_GENS,
                         "replicase_m3_cli": M3_GENS,
                         "kim_unlinked_cli": UNLINKED_GENS,
                         "avian_covarion_cli": COVARION_CLI[
                             "avian_covarion"][1]},
        "max_abs_err": max(c["max_abs_err"] for c in
                           [*eigh_cases.values(), *kc_eigh.values(),
                            *cv_eigh.values()]),
        **{k: eigh_cases["B24_S61"][k] for k in (
            "ms", "before_ms", "wrapper_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "sweeps_mean", "before_sweeps_mean")},
        "shape": "replicase NY98, 2 runs x 4 chains x 3 omega classes: "
                 "B=24 S=61",
        "cases": eigh_cases,
        "kim_codon_cases": kc_eigh,
        "covarion_cases": cv_eigh,
        "ptxas": ptxas["eigh"],
        "golden_max_err": golden_aa,
        "avian": {k: avian[k] for k in aa_keys + ("aamodel_shares",)},
        "replicase_ny98": {k: ny98[k] for k in aa_keys},
        "prior_only": aa_prior,
        "card": power_line,
    }, {
        **KERNEL_IDS[6],
        "launches": best_run["stacked_launches"],
        "gens": BEST_GENS,
        "max_abs_err": err_best,
        **{k: best_cases["finch_c8"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "loop_ms", "pruning_down_per_gene_ms", "operands_ms", "threads",
            "T", "lanes", "smem_bytes", "walks", "tiles")},
        "shape": best_cases["finch_c8"]["shape"],
        "cases": best_cases,
        "finch": best_run,
        "card": power_line,
    }]
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(power_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
