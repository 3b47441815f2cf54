#!/usr/bin/env python3
"""Drive the PyTorch port (waveformml_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc. In
order, it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from the checkout's sources (one nvcc per source,
   all at once), printing the time and each kernel's registers and spills;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the serving path and times it, the plain version and, where
   one exists, a PyTorch library composition computing the same function
   (for K1 and K4 the fastest of a few, each printed);
   K1 also on adversarial plans (full 3×3 clusters, duplicate sites, a
   ragged row count, 5→3 and 56→200 channels, single-site events with no
   off-centre tap) with the row-taps it computes, as it counts them,
   against those the data needs, K2 also on hand-made slot layouts
   (duplicate sites, stitched groups with G > S, events past the batch, a
   ragged MAX that leaves whole tiles empty) with each layout's groups,
   slots, live tiles and output row stride, K3 also on adversarial rows at the detector's sample
   counts and on rows with a gap between them; the backward kernels at
   the training shapes, K4 (row-conv weight gradient, each output within
   1e-5 of the sum of its terms' magnitudes) at each conv and on K1's
   adversarial plans, K5 (site-head backward) at the head and on K2's
   layouts, each also bitwise equal over two runs, and K1 as the feature
   gradient (reversed, transposed kernel) at convs 1-2;
4. serves SubMPSD (config/examples/SubMPSD.json widths, seeded random
   weights and head bias) through ``InferenceModel`` over 4 chunks of 4096
   synthetic events, each chunk one packed pinned copy in, one replay of
   its layout's CUDA graph and an asynchronous copy out; checks the
   graphs, replays and every launch count (those of the replays, counted
   at capture, and of the eager warm-up of a new layout), prints where the
   serving time goes, and holds the logits against the eager forward and
   the plain versions on the card and, for a few events, the CPU; serves
   the chunks' int16 ADC counts through an on-card ``preprocess`` and
   ``postprocess`` against the float32 path; and streams the chunks
   double-buffered (chunk i+1 dispatched before chunk i is fetched)
   against synchronous calls;
5. runs ``waveform_features`` over the first PMT's half of those chunks'
   waveforms and checks its launch count and outputs;
6. trains SubMPSD from the same weights with ``Trainer.fit`` (SGD with
   nesterov momentum 0.98, ExponentialLR) for 2 epochs of 4 steps over
   chunks of 4096 labelled events of both kinds, one validation chunk an
   epoch; checks the launch counts of every kernel, prints each step's
   breakdown (host prep, copy in, device time of forward + backward +
   optimizer, wall), holds the per-step losses and the first step's
   gradients against the same run with the plain versions, and serves the
   validation chunk from the best checkpoint; then, each through a
   ``DataLoaderLite`` with a background thread over 5 chunks an epoch:
   accumulation of 2 micro-steps (one carried across the epoch) with the
   global-norm clip engaged on the first optimizer step, against the plain
   versions; AdamW with CosineAnnealingLR; and a fit of 2 epochs, saved and
   resumed by a new Trainer for a third, against 3 epochs in one fit; each
   run's launch counts and per-step breakdown;
7. runs SubMPSD_w128.json as shipped (``half_precision``: bf16 features,
   float32 parameters; 130→104→110→116→122→128 stack, 128·154→199→2 head)
   from seeded random weights: K1 at its 5 convs and as d_feats, K2 at
   (128, 199), K4 and K5 against their plain versions with their times,
   bounds, per-grid times and launches a chunk and a step, and K2 and K5
   on the hand-made slot layouts at (128, 199); 4 chunks of 4096 events served
   through ``InferenceModel`` (float16 features shipped) against the plain
   versions on the card; 2 epochs × 4 steps of ``Trainer.fit`` against the
   plain versions' run (the half-precision tolerances of the CPU tests);
8. runs the CLI (``waveformml_tpu_torch.main``) for 2 epochs and a test
   pass: ``main`` over HDF5 class directories written by the port's
   writer where h5py is installed, else ``run`` over in-memory blocks,
   saying which on its own line; asserts ``version_0``, its checkpoint,
   the ``fit:``/``test:`` keys and the kernels' launches;
8b. fits SubMPSD.json 2 epochs × 4 steps with ``profiler=True`` and no
   TensorBoard logger: ``profile_results.txt`` (8 ``run_training_step``,
   8 ``get_train_batch``, 2 ``evaluation_step``, as the JAX Trainer writes
   for this loop) and a ``torch.profiler`` trace under ``profile/`` that
   names K1's, K2's, K4's and K5's grids, the losses equal to a
   profiler-off fit's (rtol 1e-5), the median step wall with the profiler
   on and off (fits off, on, on, off); then a hyperparameter study (``ModelOptimization``, TPE
   over lr and momentum, the median pruner, 4 trials of up to 3 epochs ×
   4 steps over in-memory blocks, saying so): every trial COMPLETE or
   PRUNED, each trial's launches of K1, K2, K4 and K5 asserted, the device
   memory back within 64 MiB after each trial, the samplers replayed on
   the recorded values giving the recorded params, the best trial's
   checkpoint served as the plain versions on the card, and
   ``eval_best_trials`` over the top 2 trials through ``evaluate.run``;
   prints each trial's params, state, epochs, best val_loss, wall and peak
   memory, and the study's wall (CombineData and ValidateCombined are
   host tools over HDF5 files, which need h5py: they are held on the CPU
   only, in tests/test_torch_combine.py);
8c. trains SubMPSD.json data-parallel: (a) through the CLI's ``run`` with
   ``--distributed --num_processes 1`` (one NCCL rank on the card, every
   all-reduce of the data-parallel step on one rank), 2 epochs × 4 steps
   over in-memory blocks, against the same ``run`` without a group from
   the same seeded init (fit metrics and the best checkpoint within rtol
   1e-5), K1, K2, K4 and K5 launched; (b) two ranks sharing the card over
   Gloo with CUDA tensors (Gloo stages them through the host: a check of
   the results, not of speed), each its own process started by this
   script, each on 2048 events of each of 4 blocks of 4096 events and of
   the validation block, against one process on the whole blocks from the
   same weights (each step's loss, and each weight's and running
   statistic's change over the 4 steps, held to the one process's within
   limits set between the reading of one process with each event's rows
   reordered and that of a planted fault); prints each rank's launches of K1, K2, K4 and
   K5 (each that of its steps and validation), its step walls and the
   all-reduces' share of them (``--dp-ranks N``, below, runs the ranks
   one a card over NCCL);
8d. trains SubMPSD.json tensor-parallel (``Trainer(tp=2)``, the JAX
   package's GSPMD engine): ranks sharing the card over Gloo, each its own
   process, on (a) a (1, 2) grid of (data, model) ranks, each on the whole
   blocks, and (b) a (2, 2) grid, 2048 events of each block a data rank,
   held to the one process of 8c (b) by the same readings and limits; the
   k=3 convs' weights are column blocks of Cout 52 and 28 and the head's
   of (C, F) = (8, 25) on every rank; prints each rank's launches of K1,
   K2, K4 and K5, its blocks' shapes, its step walls and the collectives'
   share of them by group (world, data, model); then (a) again from a copy
   of the port in which ``copy_to_model``'s backward is the identity (a
   planted fault, which the readings must fail); then K1 (forward, and as
   d_feats at 28→104) and K4 at Cout 52 and 28 and K2 and K5 at (8, 25),
   without the bias as the tensor-parallel layers call them, against
   their plain versions with their times, bounds, plain and library
   times (``--dp-ranks 4 --tp 2``, below, runs (b) one rank a card over
   NCCL);
9. runs the per-segment regressors as shipped, from seeded random weights
   (BatchNorm statistics of one train-mode forward): SingleEndedZCNN.json
   (150-sample pairs; conv 300→150 3×3 and 150→1 on the dense grid, cuDNN
   in float32): its grid ops timed (the convs beside their bounds, the
   first one also held to float64 with the process's TF32 flags on), 4
   serving chunks of 4096 events through ``InferenceModel`` (a CUDA graph
   per layout, the scatter and the occupancy dilation inside it) against
   the eager forward and a CPU run, 2 epochs × 4 steps of ``Trainer.fit``
   (L1, SGD with nesterov, ExponentialLR) against a CPU run, with the peak
   device memory; SegQuantifier.json (SubM 130→156→78→1 on the row path,
   SE-only MSE): K1 and K4 at its three convs against their plain versions
   (K4 bitwise over two runs), serving and training as for Z but held to
   the plain versions on the card, K1's and K4's launches asserted; then
   the CLI over SingleEndedZCNN.json, 2 epochs and a test, over in-memory
   blocks;
10. runs the sparse event classifiers as shipped, from seeded random
   weights and head biases, over chunks of 4096 events of both kinds:
   OPs3ns_SCNet.json (``SCNet``: SubM 130→32, BatchNorm, ReLU, SubM 32→8,
   ReLU in row space, ToDense, Linear 1232→32→2): K1 at both convs and as
   d_feats, K4 at both (bitwise over two runs) against their plain
   versions with their times, bounds and library times; 4 chunks served
   (held to the plain versions on the card and a CPU run) and 2 epochs × 4
   steps of ``Trainer.fit`` against the plain versions' run, every launch
   count asserted against the count derived from the code; GEP.json,
   IoniClassifierCNN.json (``SPConvNet``: the TCN, ``SparseConv2DBlock``)
   and DensePSD.json (``DenseConvNet``) on the dense grid: 4 chunks
   served (the first against a CPU run), the forward's device time by
   kernel, 2 epochs × 4 steps with two blocks' steps held to CPU steps, no
   kernel launched; then ``main --validate`` on
   OPs3ns_SCNet.json (1 epoch over in-memory blocks) and on a copy whose
   head reads 1231 features, which it refuses;
11. runs the waveform nets and the 3D net as shipped, from seeded random
   weights and biases: SingleWaveformTCN.json and SingleWaveformRNN.json
   (``LitWaveform``: the TCN, the 2-layer ReLU RNN, float32 without TF32:
   served on cuDNN, trained through PyTorch's own recurrence),
   4 chunks of 16384 single waveforms served through ``InferenceModel``
   with per-waveform detector ids as coords (waveforms/s, the device
   forward, the host share, the peak memory; the first chunk against a CPU
   run) and 2 epochs × 4 steps with two blocks' steps held to CPU steps, the
   TCN's chunks served again from its trained weights against a CPU run
   (also within a tenth of the outputs' spread), no kernel launched;
   SCNet3D.json (``SCNet``: SubMConv3d 2→8 on the [B, 2, 14, 11, 16]
   grid, Linear 19712→32→2) served and trained as the grid nets, its
   forward by kernel; then its sparse section in row space
   (``DSLSpecNet(n_t=16)``, the SubM weights carried over) against the
   grid's at every occupied site, a forward and backward against the plain
   versions with the launches asserted, K1 (2→8, and as d_feats 8→8) and
   K4 (Cin + 1 = 3, bitwise over two runs) at 27 taps against their plain
   versions with their times, bounds and library times beside cuDNN's
   conv3d of the same layer over the dense grid;
11b. runs the graph family, from seeded random weights and biases:
   IoniClassifierGraph.json as shipped (``GraphNet``: SAGEConv
   130→73→16, k = 4, masked BatchNorm, a max pool over each event,
   LinearBlock 16→2) over chunks of 4096 events of up to 12 rows: the kNN edges built
   on the host by the C++ library (built by g++ in this run, saying so)
   a chunk, timed, the first held to the numpy plain version; 4 chunks
   served through ``InferenceModel`` (a CUDA graph per row bucket and edge
   cap, the edge build its own dispatch phase), the first against a CPU
   run over every event, the forward by kernel; 2 epochs × 4 steps of
   ``Trainer.fit`` with two blocks' steps held to CPU steps; the graph
   ops (gather, segment_mean, segment_sum, edge_softmax, the max pool)
   at its shapes, each timed beside its bound with its launches a serving
   replay and a training step; ``feature_knn`` on a chunk against the
   CPU's (near-ties allowed) with its peak memory; ``GraphZNet`` under
   ``LitZ`` (65 samples) served and trained 2 epochs × 2 steps the same
   way; no hand-written kernel launched; the phase's wall time;
12. runs the prediction writers on the card, each through its own pipeline
   (prefetch reader, dispatch, three fetch workers, table writer; the HDF5
   reader and table writer replaced by the in-memory stand-ins of
   ``datasets/synthetic.py``, saying so), over 32 read chunks of seeded
   records made as the synthetic HDF5 writers make them, the last one
   short (a layout first captured under the running pipeline): Z with a
   calgroup (SingleEndedZCNN.json at 65 samples, the gains and the per-row
   gather on the card) and without, IRN (SubMPSD.json, 3 outputs: K1, K2),
   IRNIM in swap and PhysPulse modes (SegQuantifier.json's net as a
   5-class ``LitSegClassifier``: K1) and ZAndClass (both, back to back);
   first a capture of a new layout while another thread makes CUDA calls
   throughout it; each writer's rows held to its run with
   ``device="cpu"``, its launches from replays asserted and its rows/s,
   events/s, stage seconds, dispatch phases, graphs and replays printed;
   IRNIM's scores of card and CPU each against float64, both distances
   printed;
13. evaluates checkpoints on the card through ``evaluate.run``, the
   function ``python -m waveformml_tpu_torch.evaluate`` calls, over
   in-memory test chunks (no h5py there), each checkpoint written by a
   1-epoch fit: SubMPSD.json (the serving weights; ``PSDEvaluator``; K1
   and K2, their launches asserted) over 4 chunks of 4096 events,
   SegQuantifier.json (``SegEvaluator``; K1) and SingleEndedZCNN.json with
   a synthetic calibration group (``ZEvaluatorWF``: ``Calibrator``,
   ``CalCurve``, ``calc_calib_z_E``) over 2, SingleWaveformTCN.json
   (``TensorEvaluator``) over 2 chunks of 16384 waveforms,
   IoniClassifierGraph.json (``PSDEvaluator``) over one chunk; each again with
   ``--device cpu``: the outputs, and every array each evaluator accumulated, held to
   the CPU run's (argmax flips only at ties, counted); prints the test
   metrics, events/s, the per-chunk split of the test pass (host prep, copy
   in, device forward, copy back, ``add_batch`` on the host) and
   ``dump()``'s time, and the figures where matplotlib renders them (else
   that it does not);
14. exports the eval forward of nine configs that serve on the card
   and reloads it: SubMPSD.json through ``evaluate.run`` with ``--script``
   (what ``python -m waveformml_tpu_torch.evaluate --script`` runs), from
   the evaluation's checkpoint, SubMPSD_w128.json, OPs3ns_SCNet.json,
   SingleWaveformRNN.json and SCNet3D.json (1-epoch fits),
   SegQuantifier.json, SingleEndedZCNN.json, SingleWaveformTCN.json and
   IoniClassifierGraph.json through ``Trainer.export_model``; prints each
   program's custom-op nodes (K1 in the row-path ones, K2 in the SubMPSD
   ones); reloads all nine in one
   fresh process that imports torch and the port only and runs each on
   the card, its output within 1e-5 of the eager forward and its K1 and K2
   launches equal to one eager forward's; runs ``torch.library.opcheck``
   on the five ops with CUDA tensors at SubMPSD.json's shapes; and times
   the op dispatch (a K1 call, a K2 call and an eager SubMPSD.json training
   step through the ops, with the raw ctypes calls and through
   ``torch.library.custom_op`` twins of the ops);
15. runs ``analyze_records`` (scripts/analyze_waveforms.py) over the
   serving chunks' waveform pairs: K3 once a chunk, the feature means
   against the CPU run within K3's tolerance;
16. prints one JSON line describing every kernel (launches: those of the
   training run, K3's of the analysis path; K1 and K4 also at
   SegQuantifier.json's and OPs3ns_SCNet.json's widths, each with its
   training run's launches, and at 27 taps, with those of SCNet3D.json's
   row stack's forward and backward; K1, K4, K2 and K5 at phase 8d's
   column blocks, with its (2, 2) rank 0's launches), the card line again,
   and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --dp-ranks N`` runs phase 8c (b)'s check alone
with N ranks over NCCL, one a card (``dp_main``; N cards needed, e.g. a
4-card machine), and ends with the same last line; ``--dp-ranks N --tp
T`` runs phase 8d's check on an (N / T, T) grid the same way.
``python3 chip_smoke.py --tap-designs`` times K1 and K4 at 27 taps in both
designs, through their launchers, beside the library candidates
(``tap_designs_main``; one card), and ends with the same last line.
``python3 chip_smoke.py --ab-k1 DIR`` times K1 at the 9-tap and 1-tap
d_feats shapes against K1 of another checkout at DIR, A, B, B, A
(``ab_k1_main``; one card), and ends with the same last line.

Any failure raises, so the script exits non-zero without the last line.
Without CUDA, or outside a checkout, it exits non-zero before printing any
result. Times are CUDA-event medians of CUDA-graph replays (device time
with warm L2, no host launch cost, but with the card's own few µs per
replay, printed as the timing floor; K2 is also timed 20 calls to a graph).
"""
import ast
import contextlib
import copy
import ctypes
import importlib.util
import io
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "examples", "SubMPSD.json")
# the compute-heavy width, in half precision as shipped (bf16 features,
# float32 parameters)
CONFIG_W128 = os.path.join(os.path.dirname(CONFIG), "SubMPSD_w128.json")
# the per-segment regressors as shipped: Z on the dense grid (cuDNN convs),
# SegQuantifier's SubM chain on the row path (K1, K4)
CONFIG_Z = os.path.join(os.path.dirname(CONFIG), "SingleEndedZCNN.json")
CONFIG_SEGQ = os.path.join(os.path.dirname(CONFIG), "SegQuantifier.json")
# the sparse event classifiers as shipped: OPs3ns_SCNet's pure-SubM DSL stack
# in row space (K1, K4), and three on the dense grid (cuDNN): GEP and
# IoniClassifierCNN (SPConvNet, with and without the TCN), DensePSD
CONFIG_OPS = os.path.join(os.path.dirname(CONFIG), "OPs3ns_SCNet.json")
CONFIGS_GRID_NETS = tuple(os.path.join(os.path.dirname(CONFIG), f"{name}.json")
                          for name in ("GEP", "IoniClassifierCNN", "DensePSD"))
# the waveform nets as shipped (59 samples a waveform): the TCN and the
# 2-layer ReLU RNN, served in chunks of 16384 single waveforms (about what
# 4096 events hold); SCNet3D.json: SubMConv3d 2→8 on the [B, 2, 14, 11, 16]
# grid, and the same section in row space (DSLSpecNet(n_t=16): K1, K4 at 27
# taps)
CONFIGS_WAVEFORM = tuple(os.path.join(os.path.dirname(CONFIG), f"{name}.json")
                         for name in ("SingleWaveformTCN", "SingleWaveformRNN"))
CONFIG_3D = os.path.join(os.path.dirname(CONFIG), "SCNet3D.json")
# the graph family: IoniClassifierGraph.json as shipped (SAGEConv 130→73→16,
# k = 4, a max pool, LinearBlock 16→2) over events of up to 12 rows, so that
# the kNN picks 4 of up to 11 peers and integer distances tie; GraphZNet
# under LitZ at 65 samples with the hparams of tests/test_inference.py; the
# phase's wall time it is meant to stay under
CONFIG_GRAPH = os.path.join(os.path.dirname(CONFIG), "IoniClassifierGraph.json")
GRAPH_MAX_MULT = 12
GRAPH_Z_HPARAMS = {"neighbors": 1, "n_conv": 1, "n_point": 1, "conv_position": 1,
                   "graph_index": 0}
GRAPH_PHASE_TARGET_S = 60.0
# the TCN's trained serving: its card-against-CPU difference within this
# fraction of the outputs' standard deviation (they spread ~1e-05 after the
# phase's 8 steps, the size of LOGIT_ATOL)
TCN_SPREAD_TOL = 0.1
WAVEFORMS_PER_CHUNK = 16384
# training blocks of a grid net whose steps are each held to a CPU step
GRID_STEP_CHECKS = 2
# events of a serving chunk that the per-segment phases also run on the CPU
CPU_EVENTS = 256
N_CHUNKS = 4
EVENTS_PER_CHUNK = 4096       # events per batch of the repository's benchmark
SEED = 0
TIMING_SAMPLES = 25           # CUDA-event samples per timing (median)
REPLAYS_PER_SAMPLE = 10       # graph replays between two events
RUN_CALLS = 20                # calls per graph where a call is timed without a replay's cost
GRID_REPS = 20                # profiled calls per per-grid timing

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores
# and the dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# operations per waveform sample of K3's function in its whole-row form, as
# the plain version computes it: the peak, threshold and first-crossing
# reductions (7), the two one-hot selects (6), two integration windows
# (compares, weight corrections, product and sum: 18 each) and the row total
K3_OPS_PER_SAMPLE = 49
# computed row-taps of a k=3 layer may be at most this multiple of those needed
K1_MAX_COMPUTED_RATIO = 1.5
# the 27-tap instantiations' times in the tiles design, as PERF.md's kernel
# table keeps them (NVIDIA H100 80GB HBM3, 700.00 W), printed beside the
# taps design's
TILES_27_TAPS_MS = {"subm_conv_rows": 0.06290, "subm_conv_rows d_feats": 0.05604,
                    "subm_conv_rows_wgrad": 2.73904}
# (Cin, Cout) at which --tap-designs times K1 and K4 at 27 taps in both designs
TAP_DESIGN_WIDTHS = ((2, 8), (8, 8), (16, 16))
# sample counts of the detector's waveforms
K3_SAMPLE_COUNTS = (59, 65, 130, 150)

# kernel-vs-plain tolerances: the plain versions are fp32 without TF32; K1
# splits each operand for three TF32 passes (dropping only ~2^-22 relative)
# and sums K²·Cin products in another order, K2 adds an event's rows into
# its bias with atomics in a varying order, K3 rounds each row's sums once
# (double) where the plain version sums in fp32, so its total and psd are
# held to the tolerance times each row's condition number (features_close);
# K4 and K5 sum thousands of fp32 terms in another order, so each output is
# held to the tolerance times the sum of its terms' magnitudes (close_to_terms)
TOL = {"subm_conv_rows": 1e-5, "site_grouped_matmul": 1e-5, "waveform_features": 1e-5,
       "subm_conv_rows_wgrad": 1e-5, "site_grouped_matmul_bwd": 1e-5}
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
# training phase: epochs, training and validation chunks; per-step losses
# against the plain versions' run (the same init and batches: only the
# kernels' summation orders and K1's dropped small·small TF32 terms differ),
# and the first step's gradients (sums over ~10^4 rows in other orders), the
# absolute part of each parameter's tolerance GRAD_ATOL times its largest
# |gradient|, that of a conv bias before a BatchNorm (zero up to rounding)
# at least GRAD_BN_FLOOR times the largest |gradient| of any parameter
TRAIN_EPOCHS, TRAIN_CHUNKS, VAL_CHUNKS = 2, 4, 1
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
# the dense grid convs (cuDNN) against float64: each output within this
# times the sum of its terms' magnitudes, forward and both gradients
DENSE_CONV_TOL = 1e-5
# a training step on the card against the same step on the CPU from one
# state (the Z phase): its loss (the forward's sums in another order), and
# each parameter's update in norm. Two float32 runs differ there by more
# than rounding: a ReLU input or an L1 residual within the forward's
# rounding of zero takes the other branch, and each such site moves the
# update by ~1/N of its norm (N ~ 10^4 occupied sites); and the card's
# cuDNN gradient of the first conv sits further from float64 than the
# CPU's (``gradients_against_float64`` prints both). A wrong step moves it
# by O(1).
STEP_RTOL, STEP_UPDATE_RTOL = 1e-5, 1e-3
GRAD_RTOL, GRAD_ATOL, GRAD_BN_FLOOR = 1e-3, 1e-4, 1e-2
# w128 phase: the first conv rounds its sums to bf16, so a last-bit
# difference between K1 and its plain version can flip one rounding there;
# its logits and losses are held to the half-precision tolerances of the
# CPU tests against the JAX package (tests/test_torch_half.py)
HALF_LOGIT_RTOL, HALF_LOGIT_ATOL = 1e-2, 2e-3
HALF_LOSS_RTOL = 1e-3
# CLI phase: HDF5 class directories (where h5py is installed) of this many
# files of this many events a class, and the splits' events a class
CLI_FILES, CLI_EVENTS_PER_FILE = 4, 512
CLI_SPLITS = {"n_train": 1024, "n_validate": 512, "n_test": 512, "shuffled_size": 1024}
# HPO phase: the study config (TPE over lr and momentum, the median pruner
# from the first trial on), up to this many epochs a trial, and how far the
# device memory allocated after a trial may sit from its value before the
# study
HPO_STUDY = {"hyperparameters": {"/optimize_config/lr": [0.001, 0.3],
                                 "/optimize_config/optimizer_params/momentum": [0.8, 0.99]},
             "sampler": "TPESampler", "sampler_params": {"seed": 0, "n_startup_trials": 2},
             "pruner": "MedianPruner",
             "pruner_params": {"n_startup_trials": 1, "n_warmup_steps": 0,
                               "interval_steps": 1},
             "optimize_args": {"n_trials": 4}}
HPO_EPOCHS = 3
HPO_MEMORY_SLACK = 64 << 20
# writer phase: read chunks each writer streams (2048 rows a read, 1024 for
# ZAndClass, as shipped), the last one a short chunk of about this many rows
# (a new layout); events of records made (about 2.5 rows an event); the
# synthetic calibration database's group
WRITER_READS, WRITER_TAIL_ROWS, WRITER_EVENTS = 32, 320, 26500
WRITER_CALGROUP = "smokecal"
# evaluate phase: test chunks of SubMPSD.json, and of SegQuantifier.json and
# SingleEndedZCNN.json (whose CPU forward and classical reconstruction take
# seconds a chunk); each evaluator's accumulated arrays against the CPU
# run's, counts exactly, the rest to EVAL_RTOL plus EVAL_ATOL times the
# array's largest magnitude; the Z run's synthetic calibration group
EVAL_CHUNKS, EVAL_SEGMENT_CHUNKS = 4, 2
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-5
EVAL_CALGROUP = "evalcal"
# export phase: a reloaded program against the eager forward, the run-to-run
# bound of K1's and K2's float atomics; calls a block of the dispatch timing
# and its rounds (each round times every route twice, in mirrored order)
EXPORT_TOL = 1e-5
DISPATCH_CALLS, DISPATCH_ROUNDS = 100, 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def graph_time_ms(fn, calls: int = 1, samples: int = TIMING_SAMPLES) -> float:
    """Median device time of one ``fn()`` call: ``calls`` calls of fn are
    captured in one CUDA graph, and each of ``samples`` samples times
    REPLAYS_PER_SAMPLE back-to-back replays between two CUDA events. A
    replay costs the card a few µs of its own (the timing floor line), so
    with calls = 1 a call of a few µs is timed with that cost and with more
    calls mostly without."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS_PER_SAMPLE):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (REPLAYS_PER_SAMPLE * calls))
    return statistics.median(times)


def replay_time_ms(graph) -> float:
    """Median device time of one replay of a captured ``torch.cuda.CUDAGraph``
    (CUDA events around REPLAYS_PER_SAMPLE back-to-back replays)."""
    samples = []
    for _ in range(TIMING_SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS_PER_SAMPLE):
            graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / REPLAYS_PER_SAMPLE)
    return statistics.median(samples)


def kernel_name(key: str) -> str:
    """A profiler kernel key without its namespace, return type and
    arguments: ``wgrad_centre_kernel<9, 2>``."""
    key = key.replace("(anonymous namespace)::", "").split("(")[0]
    return key.split("::")[-1].replace("void ", "").strip()


def grid_times_ms(fn, reps: int = GRID_REPS) -> dict:
    """Device time of each grid that one ``fn()`` call launches, by kernel
    name: the CUDA time torch.profiler records for each kernel over ``reps``
    eager calls, divided by ``reps``. Empty where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None)
        if total is None:
            total = getattr(event, "cuda_time_total", 0.0)
        if total > 0:
            name = kernel_name(event.key)
            times[name] = times.get(name, 0.0) + total / reps / 1e3
    return times


def grid_line(times: dict) -> str:
    return (", ".join(f"{k} {v:.5f}" for k, v in sorted(times.items()))
            if times else "not measured (the profiler recorded no device time)")


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row_conv_ops(kk: int, cin: int, cout: int, needed: int) -> tuple:
    """(FLOP, peak FLOP/s) of a K1 or K4 call over ``needed`` row-taps in
    the design that takes its shape (ops/row_conv.py row_design): three
    TF32 passes of 2·Cin·Cout a row-tap on the tensor cores (tiles), or
    2·Cin·Cout in fp32 FFMA (taps)."""
    from waveformml_tpu_torch.ops.row_conv import row_design

    if row_design(kk, cin, cout) == "taps":
        return 2.0 * cin * cout * needed, FP32_FLOPS_PER_S
    return 3 * 2.0 * cin * cout * needed, TF32_FLOPS_PER_S


def fastest_library_ms(candidates: dict, label: str = "", profile: bool = False) -> float:
    """library_ms of a kernel's line: the fastest of ``candidates`` (name →
    a computation of the kernel's function in PyTorch library calls), each
    timed by graph replay of one call; with ``label``, a line of every
    candidate's time, and with ``profile`` its device time by kernel
    (torch.profiler)."""
    times = {name: graph_time_ms(fn) for name, fn in candidates.items()}
    if label:
        parts = [f"{name} {ms:.5f}" + (f" [{grid_line(grid_times_ms(candidates[name]))}]"
                                       if profile else "") for name, ms in times.items()]
        print(f"{label} library candidates (ms; the fastest is library_ms): "
              + "; ".join(parts), flush=True)
    return min(times.values())


def k1_library(feats, plan, kernel, bias, mask) -> dict:
    """K1's function (gather through the plan, GEMM, bias, row mask) in
    PyTorch library calls, for ``library_ms``: index_select, then addmm
    (mm without a bias) in K1's [N, Cout] layout, or linear with the weight
    transposed and contiguous, or addmm in the transposed [Cout, N] layout;
    embedding, indexing or gather (an element a thread) as the gather, then
    addmm; index_select along the rows of the channel-major feats [Cin, N +
    1] through the tap-major plan, then addmm in the [Cout, N] layout (the
    operands' layouts made outside the timed calls)."""
    n, cin = feats.shape
    kk, _, cout = kernel.shape
    padded = torch.cat([feats, feats.new_zeros(1, cin)])
    idx = torch.where(plan >= 0, plan, n).long()
    flat = idx.reshape(-1)
    w2 = kernel.reshape(kk * cin, cout)
    w2t = w2.t().contiguous()
    maskf = mask[:, None].float()
    mask_t = maskf.t().contiguous()
    bias_t = None if bias is None else bias[:, None].contiguous()

    def gemm(a, w, b):
        return torch.mm(a, w) if b is None else torch.addmm(b, a, w)

    def gathered():
        return torch.index_select(padded, 0, flat).view(n, kk * cin)

    each = flat[:, None].expand(-1, cin)
    padded_t = padded.t().contiguous()
    flat_t = idx.t().reshape(-1)
    w_ck = kernel.permute(2, 1, 0).reshape(cout, cin * kk)
    return {"index_select + addmm": lambda: gemm(gathered(), w2, bias).mul_(maskf),
            "index_select [Cin, N] + addmm [Cout, N]": lambda: gemm(
                w_ck, torch.index_select(padded_t, 1, flat_t).view(cin * kk, n),
                bias_t).mul_(mask_t),
            "indexing + addmm": lambda: gemm(padded[flat].view(n, kk * cin), w2,
                                             bias).mul_(maskf),
            "gather + addmm": lambda: gemm(torch.gather(padded, 0, each).view(n, kk * cin),
                                           w2, bias).mul_(maskf),
            "index_select + linear": lambda: torch.nn.functional.linear(
                gathered(), w2t, bias).mul_(maskf),
            "index_select + addmm [Cout, N]": lambda: gemm(
                w2t, gathered().t(), bias_t).mul_(mask_t),
            "embedding + addmm": lambda: gemm(torch.nn.functional.embedding(
                idx, padded).view(n, kk * cin), w2, bias).mul_(maskf)}


def k4_library(feats, plan, g, mask, with_bias: bool) -> dict:
    """K4's function (the gathered feats contracted against the masked g
    over the rows, and g's column sums) in PyTorch library calls, for
    ``library_ms``; g is masked already: index_select, then mm in K4's
    [K²·Cin, Cout] layout or in the transposed [Cout, K²·Cin] one;
    embedding, indexing or gather (an element a thread) as the gather, then
    mm; index_select along the rows of the channel-major feats [Cin, N + 1]
    through the tap-major plan, then mm in the [Cout, Cin·K²] layout (the
    operands' layouts made outside the timed calls). ``sum`` gives db."""
    n, cin = feats.shape
    kk = plan.shape[1]
    padded = torch.cat([feats, feats.new_zeros(1, cin)])
    idx = torch.where(plan >= 0, plan, n).long()
    flat = idx.reshape(-1)

    def gathered():
        return torch.index_select(padded, 0, flat).view(n, kk * cin)

    def db():
        return g.sum(0) if with_bias else None

    each = flat[:, None].expand(-1, cin)
    padded_t = padded.t().contiguous()
    flat_t = idx.t().reshape(-1)
    return {"index_select + mm": lambda: (torch.mm(gathered().t(), g), db()),
            "index_select [Cin, N] + mm [Cout, Cin·K²]": lambda: (torch.mm(
                g.t(), torch.index_select(padded_t, 1, flat_t).view(cin * kk, n).t()), db()),
            "indexing + mm": lambda: (torch.mm(padded[flat].view(n, kk * cin).t(), g), db()),
            "gather + mm": lambda: (torch.mm(torch.gather(padded, 0, each).view(
                n, kk * cin).t(), g), db()),
            "index_select + mm [Cout, K²·Cin]": lambda: (torch.mm(g.t(), gathered()), db()),
            "embedding + mm": lambda: (torch.mm(torch.nn.functional.embedding(
                idx, padded).view(n, kk * cin).t(), g), db())}


def head_bound_ms(n_bytes: float, products: float, c: int, f: int, other_flops: float = 0.0):
    """bound_ms of K2 or K5 doing ``products`` FLOP of slot products: in
    fp32 at the (8, 50) head, which has an instantiation of its own, and in
    three TF32 passes on the tensor cores at every other width. Returns
    (ms, bound_by, the fp32 bound's ms)."""
    fp32_ms = bound_ms(n_bytes, products + other_flops)[0]
    if (c, f) == (8, 50):
        return (*bound_ms(n_bytes, products + other_flops), fp32_ms)
    return (*bound_ms(n_bytes, 3 * products + other_flops, TF32_FLOPS_PER_S), fp32_ms)


def max_abs_err(got, want, tol: float) -> float:
    """Largest |got - want| over tensors, after asserting closeness."""
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        err = max(err, float((g - w).abs().max()))
    return err


# K1's adversarial plans: (label, plan kind, k, Cin, Cout, events, rows)
K1_ADVERSARIAL = (("full 3x3 clusters", "dense_cluster", 3, 130, 104, 1000, None),
                  ("duplicate sites", "duplicate_sites", 3, 104, 56, 1000, None),
                  ("N not a multiple of the tile", "clustered", 3, 130, 104, 1000,
                   78 * 64 + 37),
                  ("Cin 5, Cout 3", "clustered", 3, 5, 3, 1000, None),
                  ("Cout 200", "clustered", 3, 56, 200, 1000, None),
                  ("single-site events", "isolated_sites", 3, 130, 104, 64, None))


def check_subm_conv_rows_adversarial(rng) -> float:
    """K1 against its plain version on plans that stress its compaction,
    tiles and widths; returns the largest |error|."""
    from waveformml_tpu_torch.datasets.synthetic import conv_case
    from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows,
                                                   subm_conv_rows_plain)

    err = 0.0
    for label, kind, k, cin, cout, n_events, n_rows in K1_ADVERSARIAL:
        coords, feats, kernel, bias, mask = conv_case(rng, kind, n_events, k, cin, cout,
                                                      n_rows)
        plan = host_neighbor_plan(coords, mask, n_events, k)
        args = [torch.from_numpy(a).cuda() for a in (feats, plan, kernel, bias, mask)]
        got = subm_conv_rows(*args)
        want = subm_conv_rows_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want], TOL["subm_conv_rows"])
        print(f"K1 adversarial, {label}: N={args[0].shape[0]} K²={k * k} {cin}->{cout} "
              f"max_abs_err={e:.3g}", flush=True)
        err = max(err, e)
    return err


def check_subm_conv_rows(model, db, feats0, tag=""):
    """K1 at each conv of the SubM stack, on one chunk's batch: the first
    conv's input ``feats0`` (the batch's features as the task gives them
    to the model, widened to float32), the others random; without the bias
    where the conv has none (``tp_view``'s column blocks); lines begin
    with ``tag``."""
    from waveformml_tpu_torch.ops.row_conv import (row_design, subm_conv_rows,
                                                   subm_conv_rows_plain, take_row_taps)
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = db["mask"]
    n = mask.shape[0]
    convs = [m for m in model.stack.modules() if isinstance(m, RowSubMConv2d)]
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bytes=0.0, ops_s=0.0, max_abs_err=0.0)
    for layer, conv in enumerate(convs):
        kk, cin, cout = conv.weight.shape
        plan = db[f"plan_{conv.plan_key}"]
        if layer == 0:
            feats = feats0
        else:
            feats = torch.randn(n, cin, device="cuda", generator=gen)
            feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        bias = conv.bias.detach() if conv.bias is not None else None
        args = (feats, plan, conv.weight.detach(), bias, mask)
        take_row_taps()
        got = subm_conv_rows(*args)
        computed = take_row_taps()
        want = subm_conv_rows_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want], TOL["subm_conv_rows"])
        ms = graph_time_ms(lambda: subm_conv_rows(*args))
        plain_ms = graph_time_ms(lambda: subm_conv_rows_plain(*args))
        lib_ms = fastest_library_ms(k1_library(*args), f"{tag}K1 layer {layer}",
                                    profile=kk == 27)
        n_real = int(mask.sum())
        # the real rows' plan and feats (a real row's plan names only real
        # rows; the mask zeroes every other row), the mask, W and the bias
        # read once, the output written once over all N
        n_bytes = 4 * (n_real * cin + n_real * kk + kk * cin * cout
                       + (cout if bias is not None else 0) + n * cout) + n
        needed = int(((plan >= 0) & mask[:, None]).sum())
        # the row-taps the data needs, in the design's arithmetic
        flops, rate = row_conv_ops(kk, cin, cout, needed)
        b_ms, by = bound_ms(n_bytes, flops, rate)
        print(f"{tag}K1 subm_conv_rows layer {layer}: N={n} K²={kk} {cin}->{cout} "
              f"({row_design(kk, cin, cout)} design) ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({by}) max_abs_err={err:.3g} "
              f"real rows {n_real}, row-taps needed {needed} of {n * kk}, computed {computed} "
              f"as the kernel counted them ({computed / max(needed, 1):.3f}x)", flush=True)
        if row_design(kk, cin, cout) == "taps":
            assert computed == needed, (computed, needed)
        elif kk > 1:
            assert computed <= K1_MAX_COMPUTED_RATIO * needed, (computed, needed)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms), ("bytes", n_bytes), ("ops_s", flops / rate)):
            totals[key] += val
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    totals["bound_by"] = "bytes" if totals["bytes"] / HBM_BYTES_PER_S >= totals["ops_s"] \
        else "operations"
    return totals


# K2's hand-made layouts (datasets/synthetic.py:site_layout_case): one per
# feature, then all of them at once
K2_ADVERSARIAL = (("duplicate_sites",), ("stitched_groups",), ("events_past_end",),
                  ("ragged_max",),
                  ("duplicate_sites", "stitched_groups", "events_past_end", "ragged_max"))


def k2_layout(take, ev, n_events, out):
    """Groups, MAX, filled and live slots, and K2's tiles with a live slot
    (the tile size as the built kernel reports it) of a slot layout, and
    the row stride of K2's output ``out`` (floats; a multiple of 4, so that
    every add is a float4): (printable line, live tiles, all tiles)."""
    from waveformml_tpu_torch.ops.site_head import tile_slots

    tile = tile_slots()
    g, m = take.shape
    live = (take > 0) & (ev > 0) & (ev <= n_events)
    tiles = -(-m // tile)
    live_tiles = int(torch.nn.functional.pad(live, (0, tiles * tile - m))
                     .view(g, tiles, tile).any(-1).sum())
    return (f"groups={g} MAX={m} filled={int((take > 0).sum())} live={int(live.sum())} "
            f"live tiles={live_tiles} of {g * tiles} ({tile} slots) row stride "
            f"{out.stride(0)}"), live_tiles, g * tiles


def check_site_grouped_matmul_adversarial(rng, c, f, tag="") -> float:
    """K2 against its plain version on hand-made layouts at the head's
    widths, with the bias; lines begin with ``tag``; returns the largest
    |error|."""
    from waveformml_tpu_torch.datasets.synthetic import site_layout_case
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul,
                                                    site_grouped_matmul_plain)

    err = 0.0
    for features in K2_ADVERSARIAL:
        *arrays, bias = site_layout_case(rng, features, EVENTS_PER_CHUNK, c, f)
        rows, k3, take, ev, site = (torch.from_numpy(a).cuda() for a in arrays)
        args = (rows, k3, take, ev, site, EVENTS_PER_CHUNK, torch.from_numpy(bias).cuda())
        got = site_grouped_matmul(*args)
        want = site_grouped_matmul_plain(*args)
        torch.cuda.synchronize()
        e = max_abs_err([got], [want], TOL["site_grouped_matmul"])
        line, live_tiles, tiles = k2_layout(take, ev, EVENTS_PER_CHUNK, got)
        print(f"{tag}K2 adversarial, {'+'.join(features)}: C={c} F={f} {line} "
              f"max_abs_err={e:.3g}", flush=True)
        if "ragged_max" in features:
            # whole tiles of every group are empty: the kernel skipped them
            assert live_tiles < tiles, (live_tiles, tiles)
        err = max(err, e)
    return err


def check_site_grouped_matmul(model, db, tag=""):
    """K2 at the SubMPSD head (with its bias, where it has one; C=8, F=50 at
    SubMPSD.json's widths) on one chunk's slot layout; lines begin with
    ``tag``."""
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul,
                                                    site_grouped_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    mask = db["mask"]
    head = model.head0
    c, f, s = head.cin, head.features, NX * NY
    rows = torch.relu(torch.randn(mask.shape[0], c, device="cuda", generator=gen))
    rows = torch.where(mask[:, None], rows, 0.0).contiguous()
    k3 = head.weight.detach().view(c, s, f)
    bias = head.bias.detach() if head.bias is not None else None
    take, ev, site = db["plan_site_take"], db["plan_site_ev"], db["plan_site_s"]
    n_events = db["labels"].shape[0]
    args = (rows, k3, take, ev, site, n_events, bias)
    got = site_grouped_matmul(*args)
    want = site_grouped_matmul_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want], TOL["site_grouped_matmul"])
    layout = k2_layout(take, ev, n_events, got)[0]
    g, m = take.shape
    rows_pad = torch.cat([rows.new_zeros(1, c), rows])
    take_flat = take.reshape(-1).long()
    kg = k3[:, (site.long() - 1).clamp(0, s - 1), :].permute(1, 0, 2).contiguous()
    evs = ev.reshape(-1).long()
    idx = torch.where((evs > 0) & (evs <= n_events), evs - 1, n_events)
    out = torch.empty(n_events + 1, f, device="cuda")

    def library():
        if bias is None:
            out.zero_()
        else:
            out.copy_(bias.expand(n_events + 1, f))
        out.index_add_(0, idx, torch.bmm(torch.index_select(rows_pad, 0, take_flat)
                                         .view(g, m, c), kg).view(-1, f))

    ms = graph_time_ms(lambda: site_grouped_matmul(*args))
    plain_ms = graph_time_ms(lambda: site_grouped_matmul_plain(*args))
    library_ms = graph_time_ms(library)
    ms_run = graph_time_ms(lambda: site_grouped_matmul(*args), calls=RUN_CALLS)
    library_ms_run = graph_time_ms(library, calls=RUN_CALLS)
    grids = grid_times_ms(lambda: site_grouped_matmul(*args))
    # the function gathers the rows of live slots only (each once) and
    # multiplies each live slot once
    live = (take > 0) & (ev > 0) & (ev <= n_events)
    n_live = int(live.sum())
    rows_read = int(torch.unique(take[live]).numel())
    n_bytes = 4 * (rows_read * c + k3.numel() + 2 * g * m + g + (f if bias is not None else 0)
                   + n_events * f)
    b_ms, by, fp32_ms = head_bound_ms(n_bytes, 2.0 * c * f * n_live, c, f)
    print(f"{tag}K2 site_grouped_matmul: {layout} C={c} F={f} B={n_events} ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} bound_ms={b_ms:.6f} ({by}; "
          f"with the products in fp32 {fp32_ms:.6f}) ({n_bytes} bytes, {rows_read} rows "
          f"gathered) max_abs_err={err:.3g}; in a graph of "
          f"{RUN_CALLS} calls: ms={ms_run:.5f} library_ms={library_ms_run:.5f}; grids: "
          f"{grid_line(grids)}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=err)


def close_to_terms(got, want, scale, tol: float, label: str) -> float:
    """The backward kernels' tolerance: each output within ``tol`` times the
    sum of the magnitudes of its terms (``scale``, the plain version on the
    operands' magnitudes), since a sum of many terms in another order is off
    by a few ulp of that sum; returns the largest |error|."""
    err = 0.0
    for g, w, s in zip(got, want, scale):
        excess = float(((g - w).abs() - tol * s).max())
        assert excess <= 0, f"{label} off by {excess:.3g} beyond {tol}·Σ|terms|"
        err = max(err, float((g - w).abs().max()))
    return err


def check_bitwise(fn, label: str) -> None:
    """Two calls of fn give the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b), f"{label}: two runs differ"


def check_subm_conv_rows_wgrad(model, db, feats0, half=False, tag=""):
    """K4 at each conv of the SubM stack on one chunk's batch (each layer's
    input, the first one's ``feats0``, and a masked cotangent of its output
    width, rounded to bf16 at the first conv where ``half``, as its
    backward rounds it), bitwise determinism, and K1 as d_feats at the
    other layers against the plain _subm_bwd d_feats; without the bias's
    gradient where the conv has no bias (``tp_view``); lines begin with
    ``tag``."""
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows, subm_conv_rows_bwd_plain,
                                                   subm_conv_rows_wgrad,
                                                   subm_conv_rows_wgrad_plain,
                                                   transposed_kernel)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    mask = db["mask"]
    n = mask.shape[0]
    convs = [m for m in model.stack.modules() if isinstance(m, RowSubMConv2d)]
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0.0, ops_s=0.0,
                  max_abs_err=0.0, ms_run=0.0)
    d_feats_err = 0.0
    d_feats_ms = d_feats_bound = 0.0
    for layer, conv in enumerate(convs):
        kk, cin, cout = conv.weight.shape
        plan = db[f"plan_{conv.plan_key}"]
        if layer == 0:
            feats = feats0
        else:
            feats = torch.relu(torch.randn(n, cin, device="cuda", generator=gen))
            feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        g = torch.randn(n, cout, device="cuda", generator=gen) / n ** 0.5
        g = torch.where(mask[:, None], g, 0.0).contiguous()
        if half and layer == 0:
            g = g.to(torch.bfloat16).float()
        wb = conv.bias is not None
        args = (feats, plan, g, mask, wb)
        got = [t for t in subm_conv_rows_wgrad(*args) if t is not None]
        want = [t for t in subm_conv_rows_wgrad_plain(*args) if t is not None]
        scale = [t for t in subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask, wb)
                 if t is not None]
        err = close_to_terms(got, want, scale, TOL["subm_conv_rows_wgrad"], "K4")
        check_bitwise(lambda: [t for t in subm_conv_rows_wgrad(*args) if t is not None],
                      f"K4 layer {layer}")
        if layer > 0:
            weight = conv.weight.detach()
            w_t = transposed_kernel(weight)
            d_feats = subm_conv_rows(g, plan, w_t, None, mask)
            d_want = subm_conv_rows_bwd_plain(feats, plan, weight, mask, g)[0]
            torch.cuda.synchronize()
            e = max_abs_err([d_feats], [d_want], TOL["subm_conv_rows"])
            d_ms = graph_time_ms(lambda: subm_conv_rows(g, plan, w_t, None, mask))
            needed = int(((plan >= 0) & mask[:, None]).sum())
            n_real = int(mask.sum())
            # g and the plan over the real rows (a plan names no padding
            # row), mask and W read once, d_feats written once over all N
            d_bytes = 4 * (n_real * cout + n_real * kk + kk * cin * cout + n * cin) + n
            d_bound = bound_ms(d_bytes, *row_conv_ops(kk, cout, cin, needed))[0]
            print(f"{tag}K1 as d_feats, layer {layer}: N={n} K²={kk} {cout}->{cin} "
                  f"ms={d_ms:.5f} bound_ms={d_bound:.5f} max_abs_err={e:.3g}; grids: "
                  f"{grid_line(grid_times_ms(lambda: subm_conv_rows(g, plan, w_t, None, mask)))}",
                  flush=True)
            d_feats_err = max(d_feats_err, e)
            d_feats_ms += d_ms
            d_feats_bound += d_bound
        ms = graph_time_ms(lambda: subm_conv_rows_wgrad(*args))
        ms_run = graph_time_ms(lambda: subm_conv_rows_wgrad(*args), calls=RUN_CALLS)
        grids = grid_times_ms(lambda: subm_conv_rows_wgrad(*args))
        plain_ms = graph_time_ms(lambda: subm_conv_rows_wgrad_plain(*args))
        lib_ms = fastest_library_ms(k4_library(*args), f"{tag}K4 layer {layer}",
                                    profile=kk == 27)
        needed = int(((plan >= 0) & mask[:, None]).sum())
        n_real = int(mask.sum())
        # feats, g and the plan over the real rows (no padding row is listed
        # or summed), the mask over all N, dW and db written once
        n_bytes = 4 * (n_real * cin + n_real * kk + n_real * cout + kk * cin * cout
                       + (cout if wb else 0)) + n
        # in the design's arithmetic, as K1's bound: three TF32 passes of
        # 2·Cin·Cout per needed row-tap on the tensor cores (tiles), or fp32
        # FFMA (taps); db's n_real·Cout adds are left out
        flops, rate = row_conv_ops(kk, cin, cout, needed)
        b_ms, by = bound_ms(n_bytes, flops, rate)
        print(f"{tag}K4 subm_conv_rows_wgrad layer {layer}: N={n} K²={kk} {cin}x{cout} ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({by}) "
              f"max_abs_err={err:.3g} real rows {n_real}, row-taps {needed}, bitwise equal "
              f"over two runs; in a graph of {RUN_CALLS} calls: ms={ms_run:.5f}; grids: "
              f"{grid_line(grids)}", flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms), ("bytes", n_bytes), ("ops_s", flops / rate),
                         ("ms_run", ms_run)):
            totals[key] += val
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    totals["bound_by"] = "bytes" if totals["bytes"] / HBM_BYTES_PER_S >= totals["ops_s"] \
        else "operations"
    print(f"{tag}K4 over the {len(convs)} convs: ms={totals['ms']:.5f}, in graphs of {RUN_CALLS} "
          f"calls {totals['ms_run']:.5f}, bound_ms={totals['bound_ms']:.5f}; K1 as d_feats at "
          f"layers 1-{len(convs) - 1}: ms={d_feats_ms:.5f} bound_ms={d_feats_bound:.5f}",
          flush=True)
    return totals, d_feats_err


def check_subm_conv_rows_wgrad_adversarial(rng) -> float:
    """K4 against its plain version on K1's adversarial plans, bitwise
    determinism included; returns the largest |error|."""
    from waveformml_tpu_torch.datasets.synthetic import conv_case
    from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows_wgrad,
                                                   subm_conv_rows_wgrad_plain)

    err = 0.0
    for label, kind, k, cin, cout, n_events, n_rows in K1_ADVERSARIAL:
        coords, feats, _, _, mask = conv_case(rng, kind, n_events, k, cin, cout, n_rows)
        plan = host_neighbor_plan(coords, mask, n_events, k)
        g = rng.normal(size=(feats.shape[0], cout)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in (feats, plan, g, mask)]
        got = subm_conv_rows_wgrad(*args)
        want = subm_conv_rows_wgrad_plain(*args)
        scale = subm_conv_rows_wgrad_plain(args[0].abs(), args[1], args[2].abs(), args[3])
        e = close_to_terms(got, want, scale, TOL["subm_conv_rows_wgrad"], "K4")
        check_bitwise(lambda: subm_conv_rows_wgrad(*args), f"K4 {label}")
        print(f"K4 adversarial, {label}: N={feats.shape[0]} K²={k * k} {cin}x{cout} "
              f"max_abs_err={e:.3g}, bitwise equal over two runs", flush=True)
        err = max(err, e)
    return err


def check_site_grouped_matmul_bwd(model, db, tag=""):
    """K5 at the SubMPSD head (with its bias's gradient, where the head has
    a bias; C=8, F=50 at SubMPSD.json's widths) on one chunk's slot layout,
    bitwise determinism included; lines begin with ``tag``."""
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul_bwd,
                                                    site_grouped_matmul_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    mask = db["mask"]
    head = model.head0
    c, f, s = head.cin, head.features, NX * NY
    n = mask.shape[0]
    rows = torch.relu(torch.randn(n, c, device="cuda", generator=gen))
    rows = torch.where(mask[:, None], rows, 0.0).contiguous()
    k3 = head.weight.detach().view(c, s, f)
    take, ev, site = db["plan_site_take"], db["plan_site_ev"], db["plan_site_s"]
    n_events = db["labels"].shape[0]
    d_out = torch.randn(n_events, f, device="cuda", generator=gen) / n_events
    wb = head.bias is not None
    args = (d_out, rows, k3, take, ev, site, n_events, wb)
    got = [t for t in site_grouped_matmul_bwd(*args) if t is not None]
    want = [t for t in site_grouped_matmul_bwd_plain(*args) if t is not None]
    scale = [t for t in site_grouped_matmul_bwd_plain(d_out.abs(), rows.abs(), k3.abs(),
                                                      *args[3:]) if t is not None]
    err = close_to_terms(got, want, scale, TOL["site_grouped_matmul_bwd"], "K5")
    check_bitwise(lambda: [t for t in site_grouped_matmul_bwd(*args) if t is not None], "K5")
    g, m = take.shape
    take_flat = take.reshape(-1).long()
    evs = ev.reshape(-1).long()
    live = (evs > 0) & (evs <= n_events)
    ev_idx = torch.where(live, evs - 1, n_events)
    sg = (site.long() - 1).clamp(0, s - 1)
    kg = k3[:, sg, :].permute(1, 0, 2).contiguous()
    d_pad = torch.empty(n_events + 1, f, device="cuda")
    rows_pad = torch.cat([rows.new_zeros(1, c), rows])
    d_rows = torch.empty(n + 1, c, device="cuda")
    d_k3 = torch.empty(s, c, f, device="cuda")

    def library():
        d_pad[:n_events].copy_(d_out)
        d_pad[n_events].zero_()
        d_rowlog = torch.index_select(d_pad, 0, ev_idx).view(g, m, f)
        d_rows.zero_().index_add_(0, take_flat, torch.bmm(d_rowlog, kg.transpose(1, 2))
                                  .view(-1, c))
        rs = torch.index_select(rows_pad, 0, take_flat).view(g, m, c)
        d_k3.zero_().index_add_(0, sg, torch.bmm(rs.transpose(1, 2), d_rowlog))
        return d_out.sum(0) if wb else None

    ms = graph_time_ms(lambda: site_grouped_matmul_bwd(*args))
    ms_run = graph_time_ms(lambda: site_grouped_matmul_bwd(*args), calls=RUN_CALLS)
    grids = grid_times_ms(lambda: site_grouped_matmul_bwd(*args))
    plain_ms = graph_time_ms(lambda: site_grouped_matmul_bwd_plain(*args))
    library_ms = graph_time_ms(library)
    library_ms_run = graph_time_ms(library, calls=RUN_CALLS)
    n_live = int((live & (take_flat > 0)).sum())
    rows_read = int(torch.unique(take_flat[live & (take_flat > 0)]).numel())
    # d_out, the live slots' rows, k3 and the layout read once; d_rows, d_k3
    # and d_bias written once
    n_bytes = 4 * (n_events * f + rows_read * c + c * s * f + 2 * g * m + g
                   + n * c + c * s * f + (f if wb else 0))
    # two products of 2·C·F FLOP per live slot (d_rows, d_k3) and the bias sum
    b_ms, by, fp32_ms = head_bound_ms(n_bytes, 4.0 * c * f * n_live, c, f,
                                      n_events * f if wb else 0)
    print(f"{tag}K5 site_grouped_matmul_bwd: groups={g} MAX={m} live={n_live} C={c} F={f} "
          f"B={n_events} ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
          f"bound_ms={b_ms:.6f} ({by}; with the products in fp32 {fp32_ms:.6f}) "
          f"max_abs_err={err:.3g}, bitwise equal over two runs; "
          f"in a graph of {RUN_CALLS} calls: ms={ms_run:.5f} library_ms={library_ms_run:.5f}; "
          f"grids: {grid_line(grids)}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=err)


def check_site_grouped_matmul_bwd_adversarial(rng, c, f, tag="") -> float:
    """K5 against its plain version on K2's hand-made layouts, bitwise
    determinism included; lines begin with ``tag``; returns the largest
    |error|."""
    from waveformml_tpu_torch.datasets.synthetic import site_layout_case
    from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul_bwd,
                                                    site_grouped_matmul_bwd_plain)

    err = 0.0
    for features in K2_ADVERSARIAL:
        *arrays, _ = site_layout_case(rng, features, EVENTS_PER_CHUNK, c, f)
        d_out = rng.normal(size=(EVENTS_PER_CHUNK, f)).astype(np.float32)
        args = [torch.from_numpy(a).cuda() for a in [d_out] + arrays] + [EVENTS_PER_CHUNK]
        got = site_grouped_matmul_bwd(*args)
        want = site_grouped_matmul_bwd_plain(*args)
        scale = site_grouped_matmul_bwd_plain(*(a.abs() for a in args[:3]), *args[3:])
        e = close_to_terms(got, want, scale, TOL["site_grouped_matmul_bwd"], "K5")
        check_bitwise(lambda: site_grouped_matmul_bwd(*args), f"K5 {'+'.join(features)}")
        print(f"{tag}K5 adversarial, {'+'.join(features)}: C={c} F={f} "
              f"groups={arrays[2].shape[0]} MAX={arrays[2].shape[1]} max_abs_err={e:.3g}, "
              f"bitwise equal over two runs", flush=True)
        err = max(err, e)
    return err


def check_waveform_features(wfs_main, wfs_150, wfs_pairs, rng):
    """K3 on the feature path's input (S=65), on synthetic pulses at S=150,
    on adversarial rows at each of the detector's sample counts and on the
    first PMT's samples read in place from the [n, 2·S] pair rows; the row
    counts are not multiples of the block's rows. The max_abs_err returned
    is that of the timed input, the feature path's: where a row's psd
    cancels (signed noise), its absolute error grows as 1/|fast + slow|, so
    the other inputs are held by features_close and printed."""
    from waveformml_tpu_torch.datasets.synthetic import adversarial_waveforms
    from waveformml_tpu_torch.ops.waveform_features import (features_close,
                                                            launch_geometry,
                                                            waveform_features,
                                                            waveform_features_plain)

    s_main = wfs_main.shape[1]
    strided = wfs_pairs[:, :s_main]
    assert strided.stride(0) == 2 * s_main
    inputs = [("pulses", wfs_main), ("pulses", wfs_main[:4097]), ("pulses", wfs_150),
              ("strided rows", strided)]
    inputs += [("adversarial", torch.from_numpy(
        adversarial_waveforms(rng, 4097, s).astype(np.float32)).cuda())
        for s in K3_SAMPLE_COUNTS]
    err = 0.0
    for name, wfs in inputs:
        rows = launch_geometry(wfs.shape[1])[0]
        assert wfs.shape[0] % rows != 0 or wfs is wfs_main
        got = waveform_features(wfs)
        want = waveform_features_plain(wfs)
        torch.cuda.synchronize()
        close = features_close(got, want, wfs, TOL["waveform_features"])
        print(f"K3 {name}: n={wfs.shape[0]} S={wfs.shape[1]} row stride "
              f"{wfs.stride(0)} max_abs_err={close['max_abs_err']:.3g}; largest psd "
              f"difference {close['psd_excess']:.3g}x tol·(1+|psd|), on a row of "
              f"condition number {close['psd_kappa']:.4g}", flush=True)
        if wfs is wfs_main:
            err = close["max_abs_err"]
    ms = graph_time_ms(lambda: waveform_features(wfs_main))
    plain_ms = graph_time_ms(lambda: waveform_features_plain(wfs_main))
    n, s = wfs_main.shape
    b_ms, by = bound_ms(4 * (n * s + 4 * n), K3_OPS_PER_SAMPLE * n * s)
    print(f"K3 waveform_features: n={n} S={s} ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} max_abs_err={err:.3g}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=err)


def kernel_counts() -> dict:
    """Each kernel wrapper's launch count, by name."""
    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows, subm_conv_rows_wgrad
    from waveformml_tpu_torch.ops.site_head import site_grouped_matmul, site_grouped_matmul_bwd
    from waveformml_tpu_torch.ops.waveform_features import waveform_features

    return {fn.__name__: fn for fn in (subm_conv_rows, site_grouped_matmul, waveform_features,
                                       subm_conv_rows_wgrad, site_grouped_matmul_bwd)}


def zero_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counts().items()}


def make_trainer(cfg, state, plain: bool, checkpoint_dir=None, max_epochs=TRAIN_EPOCHS,
                 device=None, **kwargs):
    """A Trainer over the config's task and model from ``state``, on the
    card (or ``device``), with the kernels or (``plain``) their plain
    versions, forward and backward; ``kwargs`` are the Trainer's other
    arguments."""
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.registry import retrieve_class

    task = retrieve_class(cfg.run_config.run_class)(cfg, device)
    task.model.load_state_dict(state)
    for module in task.model.modules():
        if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
            module.plain = plain
    return Trainer(cfg, task, device=device, checkpoint_dir=checkpoint_dir,
                   max_epochs=max_epochs, **kwargs)


def training_launches(model, steps: int, evals: int) -> dict:
    """The kernel launches of ``steps`` training micro-steps and ``evals``
    validation batches of a model: its row convs' and site head's."""
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops.row_conv import k1_grids

    convs = [m for m in model.modules() if isinstance(m, RowSubMConv2d)]
    heads = sum(isinstance(m, FoldedSiteLinear) for m in model.modules())
    # K1's grids a call by its design (ops/row_conv.py row_design): one for
    # K² = 1 and the 27-tap design, two for the tiles design's other taps
    k1_fwd = sum(k1_grids(*m.weight.shape) for m in convs)
    # d_feats: K1 again for every conv but the first (its input is the
    # data), with Cin and Cout swapped
    k1_bwd = sum(k1_grids(m.weight.shape[0], m.weight.shape[2], m.weight.shape[1])
                 for m in convs[1:])
    return {"subm_conv_rows": steps * (k1_fwd + k1_bwd) + evals * k1_fwd,
            "site_grouped_matmul": (steps + evals) * 2 * heads,
            "waveform_features": 0,
            # K4: the centre tap's grid and the reduction's; K5: the
            # zero/bias grid and the groups' grid
            "subm_conv_rows_wgrad": steps * 2 * len(convs),
            "site_grouped_matmul_bwd": steps * 2 * heads}


def counted_fit(trainer, data, label: str) -> dict:
    """``trainer.fit(data)`` with every kernel's count set to 0 just
    before and read just after; asserts the launches of its micro-steps
    and validations and prints its per-step breakdown. Returns the
    counts."""
    epoch0 = trainer.current_epoch
    zero_counts()
    t0 = time.perf_counter()
    metrics = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = len(trainer.step_losses)
    epochs = trainer.current_epoch - epoch0
    want = training_launches(trainer.task.model, steps, epochs * len(data.val_dataloader()))
    assert launches == want, (label, launches, want)
    print(f"{label}: {epochs} epochs, {steps} steps of {trainer.step_phases[-1]['events']} events "
          f"in {wall:.3f} s, {trainer.waveforms_per_second:.1f} waveforms/s; launches "
          f"{launches}; metrics {metrics}", flush=True)
    for i, p in enumerate(trainer.step_phases):
        device = ("not measured" if p["device_ms"] is None
                  else f"{p['device_ms']:.4f} ms (CUDA events)")
        print(f"{label} breakdown step {i}: host prep {p['host_prep_s'] * 1e3:.3f} ms, "
              f"copy in {p['h2d_s'] * 1e3:.3f} ms, forward + backward + optimizer "
              f"{device}, wall {p['wall_s'] * 1e3:.3f} ms, "
              f"{1 / p['wall_s']:.2f} steps/s, {p['events'] / p['wall_s']:.1f} events/s",
              flush=True)
    assert len(trainer.step_losses) == steps and all(np.isfinite(trainer.step_losses))
    return launches


def run_training(cfg, state, train, val):
    """Trainer.fit on the card, with the kernels, then with the plain
    versions from the same init and batches; the launch counts of the
    kernels' run, the per-step breakdown, the losses against the plain
    run's, the first step's gradients against the plain run's, and the best
    checkpoint served through InferenceModel. Returns the launch counts."""
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.inference.model import InferenceModel

    data = BlockDataModule(train, val)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = make_trainer(cfg, state, plain=False, checkpoint_dir=ckpt_dir)
        launches = counted_fit(trainer, data, "training")
        losses = trainer.step_losses

        plain = make_trainer(cfg, state, plain=True)
        zero_counts()
        plain.fit(data)
        assert not any(read_counts().values())
        np.testing.assert_allclose(losses, plain.step_losses, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        print(f"training losses {np.round(losses, 6).tolist()} match the plain versions' "
              f"{np.round(plain.step_losses, 6).tolist()} (rtol={TRAIN_RTOL}, "
              f"atol={TRAIN_ATOL})", flush=True)

        # the first step's gradients, kernels against plain versions, each
        # parameter to the scale GRAD_ATOL and GRAD_BN_FLOOR describe
        grads = []
        for use_plain in (False, True):
            t = make_trainer(cfg, state, plain=use_plain)
            t.training_step(t.device_batch(train[0])[0])
            grads.append({k: p.grad for k, p in t.task.model.named_parameters()})
        specs = t.task.model.stack.specs
        before_bn = {f"stack.l{i}.bias" for i, s in enumerate(specs[:-1])
                     if s[0] == "subm" and specs[i + 1][0] == "bn"}
        largest = max(float(g.abs().max()) for g in grads[1].values())
        ratios = []
        for name, want_grad in grads[1].items():
            got_grad = grads[0][name]
            scale = float(want_grad.abs().max())
            if name in before_bn:
                scale = max(scale, GRAD_BN_FLOOR * largest)
            torch.testing.assert_close(got_grad, want_grad, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * scale,
                                       msg=lambda m, name=name: f"{name}: {m}")
            diff = float((got_grad - want_grad).abs().max())
            ratios.append(f"{name} {diff / scale:.3g} of {scale:.4g}")
        print(f"step 1 gradients of all {len(grads[0])} parameters match the plain "
              f"versions' (rtol={GRAD_RTOL}, atol={GRAD_ATOL}·each one's largest |gradient|, "
              f"floored at {GRAD_BN_FLOOR}·{largest:.4g} for the conv biases before a "
              f"BatchNorm, {sorted(before_bn)}); largest |difference| / scale: "
              f"{'; '.join(ratios)}", flush=True)

        # the best checkpoint serves the validation chunk
        server = InferenceModel(cfg, trainer.best_ckpt_path)
        logits = server(val[0].coords, val[0].feats)
        assert logits.shape == (val[0].labels.shape[0], cfg.system_config.n_type)
        assert np.isfinite(logits).all()
        served = float(torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                                         torch.from_numpy(val[0].labels)))
        np.testing.assert_allclose(served, trainer.best_val_loss, rtol=1e-4)
        print(f"best checkpoint {os.path.basename(trainer.best_ckpt_path)} serves the "
              f"validation chunk with loss {served:.6f} (recorded "
              f"{trainer.best_val_loss:.6f})", flush=True)
    return launches


def run_training_flags(cfg, state, train, val):
    """The Trainer's arguments on the card, each run through a
    ``DataLoaderLite`` that collates on a background thread
    (``num_workers=1``): accumulation of 2 micro-steps over an odd number
    of blocks an epoch with the global-norm clip engaged on the first
    optimizer step, with the kernels (training blocks shuffled) and against
    the plain versions; AdamW with CosineAnnealingLR; and a fit of 2
    epochs, saved and resumed by a new Trainer for a third, against 3
    epochs in one fit."""
    from waveformml_tpu_torch.config import Config, to_dict
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    def data(shuffle=False):
        return BlockDataModule(train, val, batch_size=1, shuffle=shuffle, num_workers=1,
                               seed=SEED)

    # the clip: half the norm of the first optimizer step's gradient (the
    # mean of the first two micro-steps' gradients, unclipped)
    probe = make_trainer(cfg, state, plain=True, accumulate_grad_batches=2)
    for block in list(data(shuffle=True).train_dataloader())[:2]:
        probe.training_step(probe.device_batch(block)[0])
    norm = float(torch.sqrt(sum(p.grad.pow(2).sum() for p in probe.params)))
    clip = 0.5 * norm
    kw = dict(accumulate_grad_batches=2, gradient_clip_val=clip)
    carried = []

    class Carry:
        def on_validation_end(self, trainer, metrics, epoch):
            carried.append(trainer.multi_steps.mini_step)

    acc = make_trainer(cfg, state, plain=False, callbacks=[Carry()], **kw)
    counted_fit(acc, data(shuffle=True), "training, accumulate 2 + clip")
    assert carried == [(len(train) * (e + 1)) % 2 for e in range(TRAIN_EPOCHS)], carried
    assert carried[0] == 1
    plain = make_trainer(cfg, state, plain=True, **kw)
    plain.fit(data(shuffle=True))
    np.testing.assert_allclose(acc.step_losses, plain.step_losses, rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL)
    print(f"accumulate 2 over {len(train)} blocks an epoch (a micro-step carried across the "
          f"epoch), clip {clip:.6g} = half the first optimizer step's gradient norm "
          f"{norm:.6g}: losses {np.round(acc.step_losses, 6).tolist()} match the plain "
          f"versions' {np.round(plain.step_losses, 6).tolist()} (rtol={TRAIN_RTOL}, "
          f"atol={TRAIN_ATOL})", flush=True)

    adamw = to_dict(cfg)
    adamw["optimize_config"].update({
        "optimizer_class": "optim.AdamW", "lr": 1e-3, "optimizer_params": {"weight_decay": 0.01},
        "scheduler_class": "lr_scheduler.CosineAnnealingLR",
        "scheduler_params": {"T_max": TRAIN_EPOCHS, "eta_min": 1e-5}})
    adam = make_trainer(Config(adamw), state, plain=False)
    counted_fit(adam, data(), "training, AdamW + CosineAnnealingLR")
    lr = adam.optimizer.param_groups[0]["lr"]
    assert lr == adam.scheduler.lr() and abs(lr - 1e-5) < 1e-12, lr
    print(f"AdamW + CosineAnnealingLR: losses {np.round(adam.step_losses, 6).tolist()}, "
          f"lr after {TRAIN_EPOCHS} epochs {lr:.6g}", flush=True)

    whole = make_trainer(cfg, state, plain=False, max_epochs=TRAIN_EPOCHS + 1)
    whole.fit(data())
    with tempfile.TemporaryDirectory() as ckpt_dir:
        first = make_trainer(cfg, state, plain=False, checkpoint_dir=ckpt_dir)
        first.fit(data())
        path = os.path.join(ckpt_dir, "last.ckpt")
        first.save_checkpoint(path)
        resumed = make_trainer(cfg, state, plain=False, max_epochs=TRAIN_EPOCHS + 1)
        resumed.load_checkpoint(path, restore_training=True)
    assert resumed.current_epoch == TRAIN_EPOCHS
    assert resumed.best_val_loss == first.best_val_loss < float("inf")
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    counted_fit(resumed, data(), "training, resumed")
    tail = whole.step_losses[-len(train):]
    np.testing.assert_allclose(resumed.step_losses, tail, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    print(f"resumed at epoch {TRAIN_EPOCHS} (best val_loss {resumed.best_val_loss:.6f}): losses "
          f"{np.round(resumed.step_losses, 6).tolist()} match an uninterrupted "
          f"{TRAIN_EPOCHS + 1}-epoch fit's last epoch {np.round(tail, 6).tolist()} "
          f"(rtol={TRAIN_RTOL}, atol={TRAIN_ATOL})", flush=True)


def run_w128(chunks, train, val):
    """SubMPSD_w128.json as shipped (bf16 features, published widths:
    130→104→110→116→122 k=3, 122→128 k=1, head 128·154→199→2), seeded
    random weights and head bias: K1 at its 5 convs and as d_feats, K2,
    K4 and K5 at those shapes against their plain versions (K4 and K5
    bitwise over two runs, too), K2 and K5 also on the hand-made slot
    layouts at the head's (C, F); 4 serving chunks of 4096 events through
    ``InferenceModel`` (float16 features shipped, the bf16 cast inside the
    graph), against the plain versions on the card; and 2 epochs × 4 steps
    of ``Trainer.fit``, against the plain versions' run. Returns each
    kernel's numbers at these shapes."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.detector import MAX_RANGE
    from waveformml_tpu_torch.inference.model import InferenceModel
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops.row_conv import k1_grids

    cfg = load_config(CONFIG_W128)
    assert cfg.system_config.half_precision
    state = w128_state(cfg)
    # float16 features, as half precision's datasets give them
    inputs = [(ch["coords"], (ch["waveforms"] / MAX_RANGE).astype(np.float16))
              for ch in chunks]
    server = InferenceModel(cfg, state)
    t0 = time.perf_counter()
    server(*inputs[0])
    torch.cuda.synchronize()
    print(f"w128 first chunk (capture of its layout): {time.perf_counter() - t0:.3f} s",
          flush=True)

    task = server.task
    block = FileBlock(inputs[0][0], inputs[0][1], np.zeros(EVENTS_PER_CHUNK, np.int64))
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    assert db["feats"].dtype == torch.float16
    # the first conv's input as its forward gives it to K1: bf16, widened
    feats0 = task._features(db).float().contiguous()
    convs = [m for m in task.model.stack.modules() if isinstance(m, RowSubMConv2d)]
    print(f"w128 stack: {[tuple(m.weight.shape) for m in convs]}, head C={task.model.head0.cin} "
          f"F={task.model.head0.features}", flush=True)
    results = {"subm_conv_rows": check_subm_conv_rows(task.model, db, feats0, tag="w128 "),
               "site_grouped_matmul": check_site_grouped_matmul(task.model, db, tag="w128 ")}
    results["subm_conv_rows_wgrad"], d_feats_err = check_subm_conv_rows_wgrad(
        task.model, db, feats0, half=True, tag="w128 ")
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_feats_err)
    results["site_grouped_matmul_bwd"] = check_site_grouped_matmul_bwd(task.model, db,
                                                                       tag="w128 ")
    # the hand-made layouts (stitched groups, whose sites sum by tickets,
    # included) at the wide head
    rng = np.random.default_rng(SEED + 11)
    head = task.model.head0
    for name, check in (("site_grouped_matmul", check_site_grouped_matmul_adversarial),
                        ("site_grouped_matmul_bwd", check_site_grouped_matmul_bwd_adversarial)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           check(rng, head.cin, head.features, tag="w128 "))

    # serving: each chunk one replay of its layout's graph
    for g in server.graphs.values():
        g.replays = 0
    graphs_before = len(server.graphs)
    zero_counts()
    t0 = time.perf_counter()
    handles = [server.dispatch(c, f) for c, f in inputs]
    logits = [server.fetch(h) for h in handles]
    wall = time.perf_counter() - t0
    eager, replayed = read_counts(), server.replay_launches()
    launches = {k: eager[k] + replayed[k] for k in eager}
    new_graphs = len(server.graphs) - graphs_before
    per_chunk = dict.fromkeys(launches, 0)
    per_chunk.update(subm_conv_rows=sum(k1_grids(*m.weight.shape) for m in convs),
                     site_grouped_matmul=2)
    assert sum(g.replays for g in server.graphs.values()) == N_CHUNKS
    assert replayed == {k: v * N_CHUNKS for k, v in per_chunk.items()}, replayed
    assert eager == {k: v * new_graphs for k, v in per_chunk.items()}, eager
    forward_ms = graph_time_ms(lambda: task.apply_model(db))
    n_events = N_CHUNKS * EVENTS_PER_CHUNK
    print(f"w128 serving: {N_CHUNKS} chunks, {n_events} events in {wall:.4f} s = "
          f"{n_events / wall:.1f} events/s; device forward {forward_ms:.4f} ms a chunk; "
          f"launches {launches}, of which from replays {replayed}; packed chunk bytes "
          f"{[sum(leaf[4] for leaf in spec) for spec in server.graphs]}", flush=True)
    reference = InferenceModel(cfg, state)
    for module in reference.task.model.modules():
        if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
            module.plain = True
    agree, err = 0, 0.0
    for (c, f), out in zip(inputs, logits):
        assert out.shape == (EVENTS_PER_CHUNK, cfg.system_config.n_type)
        assert np.isfinite(out).all()
        want = reference(c, f)
        np.testing.assert_allclose(out, want, rtol=HALF_LOGIT_RTOL, atol=HALF_LOGIT_ATOL)
        agree += int((out.argmax(-1) == want.argmax(-1)).sum())
        err = max(err, float(np.abs(out - want).max()))
    print(f"w128 logits match the plain versions on the card (largest |difference| {err:.3g}, "
          f"rtol={HALF_LOGIT_RTOL}, atol={HALF_LOGIT_ATOL}); argmax agrees on "
          f"{agree}/{n_events} events", flush=True)

    # training, float16 features as the datasets give them
    data = BlockDataModule(half_blocks(train), half_blocks(val))
    trainer = make_trainer(cfg, state, plain=False)
    step = counted_fit(trainer, data, "w128 training")
    plain = make_trainer(cfg, state, plain=True)
    zero_counts()
    plain.fit(data)
    assert not any(read_counts().values())
    np.testing.assert_allclose(trainer.step_losses, plain.step_losses, rtol=HALF_LOSS_RTOL)
    print(f"w128 training losses {np.round(trainer.step_losses, 6).tolist()} match the plain "
          f"versions' {np.round(plain.step_losses, 6).tolist()} (rtol={HALF_LOSS_RTOL})",
          flush=True)
    a_step = training_launches(task.model, 1, 0)
    for name, r in results.items():
        print(f"w128 {name}: ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f} "
              f"max_abs_err={r['max_abs_err']:.3g}; launches a serving chunk "
              f"{per_chunk[name]}, a training step {a_step[name]}; in the training run "
              f"{step[name]}", flush=True)
    return results


def w128_state(cfg) -> dict:
    """SubMPSD_w128.json's model with seeded random weights and head bias,
    as a state_dict."""
    from waveformml_tpu_torch.models.nets import SubMPSDNet

    gen = torch.Generator().manual_seed(SEED + 10)
    model = SubMPSDNet(cfg, generator=gen)
    with torch.no_grad():
        model.head0.bias.normal_(generator=gen)
    return model.state_dict()


def half_blocks(blocks):
    """Blocks with float16 features, as half precision's datasets give them."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock

    return [FileBlock(b.coords, b.feats.astype(np.float16), b.labels) for b in blocks]


def seeded_state(cfg, seed: int, block) -> dict:
    """The config's model with seeded random weights, as a state_dict: its
    init, every bias drawn from |N(0, 0.1)| (init leaves them zero), and
    the BatchNorm running statistics set to those of one train-mode forward
    over ``block`` (as training leaves them near the data's), so that the
    eval outputs vary with the data instead of sitting on one side of the
    final ReLU."""
    from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm
    from waveformml_tpu_torch.registry import retrieve_class

    gen = torch.Generator().manual_seed(seed)
    model = retrieve_class(cfg.net_config.net_class)(cfg, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen).abs_()
    task = retrieve_class(cfg.run_config.run_class)(cfg)
    task.model.load_state_dict(model.state_dict())
    norms = [m for m in task.model.modules() if isinstance(m, MaskedArrayBatchNorm)]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        task.model_outputs(prepared(task, block), train=True)
    return {k: v.cpu() for k, v in task.model.state_dict().items()}


def set_plain(model, plain: bool) -> None:
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

    for module in model.modules():
        if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
            module.plain = plain


def prepared(task, block):
    """A block prepared by ``task`` and on its device."""
    return task.to_device(task.prepare_block(block, task.row_bucket(block),
                                             task.event_bucket(block)))


def run_segment_serving(cfg, state, chunks, tag, cpu_events=CPU_EVENTS):
    """A per-segment config (or an event classifier) served through
    ``InferenceModel`` on the card: each chunk one packed copy in, one
    replay of its layout's CUDA graph (the grid scatter, the occupancy
    dilation and the convs inside it) and a copy out; the graphs, replays
    and launches asserted; where the serving time goes; the outputs held to
    the eager forward, to the plain versions on the card (where the model
    has row convs) and, for the first ``cpu_events`` events of the first
    chunk (all of them where None), to a CPU run of the port. Returns the
    launches."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.inference.model import InferenceModel
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

    server = InferenceModel(cfg, state)
    task = server.task
    t0 = time.perf_counter()
    server(*chunks[0])
    torch.cuda.synchronize()
    print(f"{tag} first chunk (capture of its layout): {time.perf_counter() - t0:.3f} s",
          flush=True)
    server.dispatch_phases = dict.fromkeys(server.dispatch_phases, 0.0)
    for g in server.graphs.values():
        g.replays = 0
    graphs_before = len(server.graphs)
    zero_counts()
    t0 = time.perf_counter()
    handles = [server.dispatch(c, f) for c, f in chunks]
    outs = [server.fetch(h) for h in handles]
    wall = time.perf_counter() - t0
    eager, replayed = read_counts(), server.replay_launches()
    launches = {k: eager[k] + replayed[k] for k in eager}
    new_graphs = len(server.graphs) - graphs_before
    per_chunk = training_launches(task.model, 0, 1)
    assert sum(g.replays for g in server.graphs.values()) == N_CHUNKS
    assert replayed == {k: v * N_CHUNKS for k, v in per_chunk.items()}, replayed
    assert eager == {k: v * new_graphs for k, v in per_chunk.items()}, eager
    served_ms = [replay_time_ms(g.graph) for g in server.graphs.values()]
    n_events = N_CHUNKS * EVENTS_PER_CHUNK
    names = {"host_prep_s": "host prep (pad, plans, pack)", "h2d_s": "copy in",
             "launch_s": "replay + copy out", "fetch_s": "fetch",
             "edge_build_s": "of host prep, the C++ edge build"}
    phases = "; ".join(f"{names[k]} {v * 1e3 / N_CHUNKS:.3f} ({v / wall:.1%})"
                       for k, v in server.dispatch_phases.items())
    packed = [sum(leaf[4] for leaf in spec) for spec in server.graphs]
    print(f"{tag} serving: {N_CHUNKS} chunks, {n_events} events in {wall:.4f} s = "
          f"{n_events / wall:.1f} events/s; graphs {len(server.graphs)}, launches {launches}, "
          f"of which from replays {replayed}", flush=True)
    if task.is_graph:
        layouts = {}
        for spec in server.graphs:
            shapes = {leaf[0]: leaf[1] for leaf in spec}
            key = (shapes["coords"][0], tuple(sorted(
                (k[len("edges_"):], v[1]) for k, v in shapes.items() if k.startswith("edges_"))))
            layouts[key] = layouts.get(key, 0) + 1
        print(f"{tag} serving: graphs captured per (row bucket, edge caps): "
              + "; ".join(f"{rb} rows, edges {dict(caps)}: {n}"
                          for (rb, caps), n in sorted(layouts.items())), flush=True)
    # the device is busy for the serving graphs' replays: their own time (a
    # graph of the eager forward may get other cuDNN algorithms than the
    # serving graph, captured into its memory pool, as the grid nets show)
    busy = sum(ms * g.replays for ms, g in zip(served_ms, server.graphs.values()))
    print(f"{tag} serving breakdown (ms/chunk, share of wall): {phases}; device forward "
          f"(a replay of each serving graph) {[round(ms, 4) for ms in served_ms]}; wall "
          f"{wall * 1e3 / N_CHUNKS:.3f}; device "
          f"busy share {busy / (wall * 1e3):.4f} (the serving replays' time over the wall); "
          f"packed chunk bytes {packed}", flush=True)

    row = task.output_unit == "row"
    classifier = hasattr(task, "n_type")
    has_rows = any(isinstance(m, RowSubMConv2d) for m in task.model.modules())
    reference = InferenceModel(cfg, state) if has_rows else None
    if reference is not None:
        set_plain(reference.task.model, True)
    err_eager = err_plain = 0.0
    for (c, f), out in zip(chunks, outs):
        want_shape = ((c.shape[0], 1) if row else (EVENTS_PER_CHUNK, task.n_type) if classifier
                      else (EVENTS_PER_CHUNK, 1, 14, 11))
        assert out.shape == want_shape and np.isfinite(out).all(), out.shape
        n = c.shape[0] if row else EVENTS_PER_CHUNK
        direct = task.apply_model(prepared(task, FileBlock(
            c, f, np.zeros(c.shape[0], np.float32))))[:n].cpu().numpy()
        np.testing.assert_allclose(out, direct, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        err_eager = max(err_eager, float(np.abs(out - direct).max()))
        if reference is not None:
            want = reference(c, f)
            np.testing.assert_allclose(out, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
            err_plain = max(err_plain, float(np.abs(out - want).max()))
    if classifier:
        # the logits vary with the events: each class is some event's argmax
        picked = np.concatenate([o.argmax(-1) for o in outs])
        live = float(np.mean(picked == 0))
        what = f"class 0 the argmax of {live:.3f} of the events"
    else:
        # the outputs at the real rows: most of them live
        live = float(np.mean(np.concatenate([
            (o[:, 0] if row else o[c[:, -1], 0, c[:, 0], c[:, 1]]) != 0
            for (c, _), o in zip(chunks, outs)])))
        what = f"{live:.3f} of those at real rows nonzero"
        assert live > 0.05, live
    cpu_s, cpu_err, n_cpu = 0.0, 0.0, 0
    cpu_server = InferenceModel(cfg, state, device="cpu")
    for (c, f), out in zip(chunks[:1], outs):
        pick = c[:, -1] < cpu_events if cpu_events else np.ones(c.shape[0], bool)
        t0 = time.perf_counter()
        cpu = cpu_server(c[pick], f[pick])
        cpu_s += time.perf_counter() - t0
        card = server(c[pick], f[pick]) if cpu_events else out
        np.testing.assert_allclose(card, cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        cpu_err = max(cpu_err, float(np.abs(card - cpu).max()))
        n_cpu += cpu.shape[0] if not row else int(np.unique(c[pick][:, -1]).size)
    print(f"{tag} outputs {outs[0].shape} a chunk, {what}: "
          f"the graph path matches the eager forward (largest |difference| {err_eager:.3g})"
          + (f" and the plain versions on the card ({err_plain:.3g})" if has_rows else "")
          + f", and {n_cpu} events match a CPU run of the port ({cpu_s:.2f} s; largest "
          f"|difference| {cpu_err:.3g}) (rtol={LOGIT_RTOL}, atol={LOGIT_ATOL})", flush=True)
    return launches


def run_segment_training(cfg, state, train, val, tag, reference: str,
                         trained_state=None) -> dict:
    """``Trainer.fit`` of a config on the card, 2 epochs × 4 steps, with
    each kernel's count set to 0 before and read after (and asserted), the
    per-step breakdown and the peak device memory; the losses held to the
    same run with the plain versions on the card (``reference="plain"``) or
    on the CPU (``"cpu"``: the free-running trajectory printed, each step
    held to a CPU step from the card's state), or only each of the first
    GRID_STEP_CHECKS training blocks' steps held to a CPU step from the
    card's state (``"steps"``); the best checkpoint's test loss against its
    recorded validation loss. Where ``trained_state`` is a dict, it receives
    the weights the fit ends with. Returns the launches."""
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.inference.model import InferenceModel

    data = BlockDataModule(train, val)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = make_trainer(cfg, state, plain=False, checkpoint_dir=ckpt_dir)
        torch.cuda.reset_peak_memory_stats()
        launches = counted_fit(trainer, data, f"{tag} training")
        peak = torch.cuda.max_memory_allocated()
        if trained_state is not None:
            trained_state.update({k: v.detach().cpu().clone()
                                  for k, v in trainer.task.model.state_dict().items()})
        print(f"{tag} training: peak device memory {peak / 2**30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated); losses "
              f"{np.round(trainer.step_losses, 6).tolist()}", flush=True)
        if reference == "steps":
            t0 = time.perf_counter()
            check_steps_on_cpu(cfg, state, train[:GRID_STEP_CHECKS], tag)
            print(f"{tag} training: the step checks took {time.perf_counter() - t0:.1f} s",
                  flush=True)
        else:
            t0 = time.perf_counter()
            ref = make_trainer(cfg, state, plain=True,
                               device="cpu" if reference == "cpu" else None)
            zero_counts()
            ref.fit(data)
            assert not any(read_counts().values())
            print(f"{tag} training: the "
                  f"{'plain versions on the card' if reference == 'plain' else 'CPU run'} "
                  f"({time.perf_counter() - t0:.1f} s): "
                  f"{np.round(ref.step_losses, 6).tolist()}", flush=True)
        if reference == "plain":
            np.testing.assert_allclose(trainer.step_losses, ref.step_losses,
                                       rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
            print(f"{tag} training losses match the plain versions' (rtol={TRAIN_RTOL}, "
                  f"atol={TRAIN_ATOL})", flush=True)
        elif reference == "cpu":
            rel = np.abs(np.subtract(trainer.step_losses, ref.step_losses)) / np.abs(
                ref.step_losses)
            again = make_trainer(cfg, state, plain=False)
            again.fit(data)
            card_rel = np.abs(np.subtract(trainer.step_losses, again.step_losses)) / np.abs(
                again.step_losses)
            print(f"{tag} training: the free-running card and CPU trajectories part by "
                  f"{np.array2string(rel, precision=3)} (relative, per step), two card runs "
                  f"by {np.array2string(card_rel, precision=3)}; each step from one state "
                  f"is held below", flush=True)
            check_steps_on_cpu(cfg, state, train + val, tag)
            gradients_against_float64(cfg, state, train[0], tag)
        best = make_trainer(cfg, state, plain=False)
        best.load_checkpoint(trainer.best_ckpt_path)
        test = best.test(BlockDataModule([], [], val))
        np.testing.assert_allclose(test["test_loss"], trainer.best_val_loss, rtol=1e-4)
        served = InferenceModel(cfg, trainer.best_ckpt_path)(val[0].coords, val[0].feats)
        assert np.isfinite(served).all()
        print(f"{tag} best checkpoint {os.path.basename(trainer.best_ckpt_path)}: test "
              f"metrics on the validation chunk {test} (recorded val_loss "
              f"{trainer.best_val_loss:.6f}); served outputs {served.shape}", flush=True)
    return launches


def biases_before_batchnorm(model):
    """The parameter names of the conv biases that a BatchNorm follows:
    their gradient is rounding. Returns those of the sparse stacks (a
    ``_SpecNet``'s or a DSL's ``SparseSequential``) and the graph convs,
    whose BatchNorm sums the occupied sites or real rows, and those of
    ``Conv2DBlock``, whose BatchNorm sums
    every site of every real event (~6·10^5 terms a channel at 4096
    events, most of them the bias alone)."""
    from waveformml_tpu_torch.models.blocks import Conv2DBlock
    from waveformml_tpu_torch.models.graph_net import GraphNet, GraphZ
    from waveformml_tpu_torch.models.sparse_blocks import _SpecNet
    from waveformml_tpu_torch.ops.sparse_conv import MaskedBatchNorm, SparseSequential

    params = dict(model.named_parameters())
    sparse, dense = set(), set()
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, (GraphNet, GraphZ)):
            # a graph conv's output bias (every row's, before its masked
            # BatchNorm over the real rows): SAGEConv's lin_l, GraphConv's
            # lin_rel, GCN's own
            for child, _ in module.named_children():
                if child.startswith("gconv_") and hasattr(module, f"norm_{child[6:]}"):
                    sparse |= {f"{prefix}{child}.{b}" for b in ("bias", "lin_l.bias",
                                                              "lin_rel.bias")} & set(params)
        elif isinstance(module, _SpecNet):
            specs = module.specs
            for i in range(len(specs) - 1):
                if specs[i + 1][0] == "bn":
                    sparse |= {k for k in (f"{prefix}l{i}.conv.bias", f"{prefix}l{i}.bias")
                               if k in params}
        elif isinstance(module, SparseSequential):
            for i in range(module.n - 1):
                if isinstance(getattr(module, f"layers_{i + 1}"), MaskedBatchNorm):
                    sparse |= {f"{prefix}layers_{i}.conv.bias"} & set(params)
        elif isinstance(module, Conv2DBlock):
            dense |= {f"{prefix}conv_{i}.bias" for i in range(len(module.layers))}
    return sparse, dense


def check_steps_on_cpu(cfg, state, blocks, tag) -> None:
    """Training steps on the card, one a block of ``blocks`` in turn, each
    against the same step on the CPU taken from the card's state just
    before it (weights, BatchNorm statistics, momentum): the step's loss
    within STEP_RTOL, and each parameter's update (forward, backward and
    optimizer; ``p.grad`` is no witness after the step: the card's SGD
    adds its momentum into it in place, the CPU's does not) within
    STEP_UPDATE_RTOL of the CPU's in norm (a conv bias before a
    BatchNorm, whose update is rounding, of GRAD_BN_FLOOR times the largest
    update norm; before a dense grid's BatchNorm, each device's update of
    it within GRAD_BN_FLOOR times the largest update norm, the two
    roundings not compared). A free-running trajectory
    compounds every difference of two summation orders; these steps do
    not."""
    card = make_trainer(cfg, state, plain=False)
    cpu = make_trainer(cfg, state, plain=True, device="cpu")
    # a conv bias before a BatchNorm moves by rounding only; before a dense
    # grid's BatchNorm that rounding is of sums of ~10^5-10^6 cancelling
    # terms, so there each device's update is held to rounding on its own
    before_bn, before_dense_bn = biases_before_batchnorm(card.task.model)
    worst_dense = 0.0
    worst_loss = worst_norm = worst_elem = 0.0
    worst_name = None
    for block in blocks:
        cpu.task.model.load_state_dict(card.task.model.state_dict())
        # a copy: on one device the two optimizers would share momentum buffers
        cpu.optimizer.load_state_dict(copy.deepcopy(card.optimizer.state_dict()))
        before = {k: p.detach().cpu().clone() for k, p in cpu.task.model.named_parameters()}
        got = float(card.training_step(card.device_batch(block)[0])[0])
        want = float(cpu.training_step(cpu.device_batch(block)[0])[0])
        np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
        worst_loss = max(worst_loss, abs(got - want) / abs(want))
        cpu_params = dict(cpu.task.model.named_parameters())
        diffs = {}
        for name, p in card.task.model.named_parameters():
            update = p.detach().cpu() - before[name]
            want_update = cpu_params[name].detach() - before[name]
            diffs[name] = (float((update - want_update).norm()), float(want_update.norm()))
            if name in before_dense_bn:
                moved = max(float(update.norm()), float(want_update.norm()))
                diffs[name] = (moved, 0.0)
            elif name not in before_bn:
                worst_elem = max(worst_elem, float((update - want_update).abs().max())
                                 / max(float(want_update.abs().max()), 1e-30))
        largest = max(norm for _, norm in diffs.values())
        for name, (diff, norm) in diffs.items():
            if name in before_dense_bn:
                # each device moved it by rounding: far below a trained update
                assert diff <= GRAD_BN_FLOOR * largest, (name, diff, largest)
                worst_dense = max(worst_dense, diff / largest)
                continue
            if name in before_bn:
                norm = max(norm, GRAD_BN_FLOOR * largest)
            assert diff <= STEP_UPDATE_RTOL * norm, (name, diff, norm)
            if diff / max(norm, 1e-30) >= worst_norm:
                worst_norm, worst_name = diff / max(norm, 1e-30), name
    print(f"{tag} training, {len(blocks)} steps each from the card's state: losses within "
          f"{worst_loss:.3g} (relative; rtol={STEP_RTOL}), every parameter's update within "
          f"{worst_norm:.3g} of the CPU's in norm ({worst_name}; ≤ {STEP_UPDATE_RTOL}; for "
          f"the conv biases "
          f"before a BatchNorm, {sorted(before_bn)}, of {GRAD_BN_FLOOR}·the largest update "
          f"norm); largest element difference {worst_elem:.3g} of the parameter's largest "
          f"|update|" + (f"; the conv biases before the dense grid's BatchNorm, "
                         f"{sorted(before_dense_bn)}, moved by at most {worst_dense:.3g} of the "
                         f"largest update norm on either device (≤ {GRAD_BN_FLOOR})"
                         if before_dense_bn else ""), flush=True)


def gradients_against_float64(cfg, state, block, tag) -> None:
    """Prints how far one step's gradients (weights from ``state``, one
    block, before any optimizer step) lie from float64, in norm, on the
    card and on the CPU, each parameter but the conv biases before a
    BatchNorm (whose gradient is rounding)."""
    from waveformml_tpu_torch.registry import retrieve_class

    def grads(device, dtype):
        task = retrieve_class(cfg.run_config.run_class)(cfg, device)
        task.model.load_state_dict(state)
        task.model.to(dtype)
        db = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in prepared(task, block).items()}
        task.model.train(True)
        loss_sum, weight, _ = task.loss_and_metrics(task.forward_model(db), db)
        (loss_sum / weight).backward()
        return {k: p.grad.double().cpu() for k, p in task.model.named_parameters()}

    exact = grads("cuda", torch.float64)
    rows = {}
    for where in ("cuda", "cpu"):
        g = grads(where, torch.float32)
        rows[where] = {k: float((g[k] - exact[k]).norm() / exact[k].norm())
                       for k in exact if float(exact[k].norm()) > 1e-3 * max(
                           float(v.norm()) for v in exact.values())}
    print(f"{tag} one step's gradients against float64 (norm-relative), card: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rows["cuda"].items())
          + "; CPU: " + ", ".join(f"{k} {v:.3g}" for k, v in rows["cpu"].items()), flush=True)


def check_dense_convs(cfg, state, chunk, tag) -> dict:
    """The Z stack's grid ops on one serving chunk, timed alone as graph
    replays: the scatter to the grid (rows and occupancy), the occupancy
    dilation, and the two convs (cuDNN, float32 without TF32), each beside
    its bound (float32 operations outside the tensor cores, every site of
    the grid); the first conv also held, with the process's TF32 flags on,
    to a float64 run within 1e-5 of each output's terms' magnitudes (a TF32
    conv misses that by orders of magnitude)."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.engineering.tasks import LitZ
    from waveformml_tpu_torch.ops import sparse_conv as sc

    task = LitZ(cfg)
    task.model.load_state_dict(state)
    task.model.eval()
    db = prepared(task, FileBlock(chunk[0], chunk[1], np.zeros(chunk[0].shape[0], np.float32)))
    batch = task.sparse_batch(db)
    stack = task.model.stack
    grid = sc.batch_to_grid(batch)
    with torch.no_grad():
        x0 = grid.masked()
        mid = stack.l1(stack.l0(grid))
        x1 = torch.relu(mid.features) * mid.occupancy[:, None]
    b, s = x0.shape[0], 14 * 11
    out = {}
    for name, layer, x in (("conv 300->150 3x3", stack.l0, x0),
                           ("conv 150->1 1x1", stack.l3, x1)):
        w, bias = layer.conv.weight.detach(), layer.conv.bias.detach()
        cout, cin, kh, kw = w.shape
        pad = (kh // 2, kw // 2)
        ms = graph_time_ms(lambda: sc.conv(x, w, bias, (1, 1), pad, (1, 1)))
        n_bytes = 4 * (x.numel() + w.numel() + cout + b * s * cout)
        flops = 2.0 * b * s * cout * cin * kh * kw
        b_ms, by = bound_ms(n_bytes, flops)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"{tag} cuDNN {name}: x {tuple(x.shape)} ms={ms:.5f} bound_ms={b_ms:.5f} ({by}, "
              f"float32 at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s over every site)", flush=True)
    for name, fn in (("scatter to the grid", lambda: sc.batch_to_grid(batch)),
                     ("occupancy dilation 3x3", lambda: sc.dilate_occupancy(
                         grid.occupancy, 3, 1, 1, 1))):
        out[name] = dict(ms=graph_time_ms(fn))
        print(f"{tag} {name}: ms={out[name]['ms']:.5f}", flush=True)

    # float32 whatever the process's flags say: the first conv's forward,
    # weight gradient and input gradient with the TF32 flags on, against
    # float64, each output within DENSE_CONV_TOL of the sum of its terms'
    # magnitudes (the same function of |operands|)
    w, bias = stack.l0.conv.weight.detach(), stack.l0.conv.bias.detach()
    xs = x0[:64].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    gy = torch.randn((64, w.shape[0]) + xs.shape[2:], device="cuda", generator=gen)
    geometry = ([1, 1], [1, 1], [1, 1], False, [0, 0], 1)
    conv_api = getattr(torch.backends.cudnn, "conv", None)
    new_api = conv_api is not None and hasattr(conv_api, "fp32_precision")
    saved = conv_api.fp32_precision if new_api else torch.backends.cudnn.allow_tf32
    try:
        if new_api:
            conv_api.fp32_precision = "tf32"
        else:
            torch.backends.cudnn.allow_tf32 = True
        xg, wg = xs.clone().requires_grad_(), w.clone().requires_grad_()
        y = sc.conv(xg, wg, bias, (1, 1), (1, 1), (1, 1))
        y.backward(gy)
        got = (y.detach(), wg.grad, xg.grad)
        tf32 = torch.nn.functional.conv2d(xs, w, bias, padding=1)
    finally:
        if new_api:
            conv_api.fp32_precision = saved
        else:
            torch.backends.cudnn.allow_tf32 = saved

    def f64(x, weight, g, b=None):
        x, weight, g = x.double().cpu(), weight.double().cpu(), g.double().cpu()
        out = torch.nn.functional.conv2d(x, weight, None if b is None else b.double().cpu(),
                                         padding=1)
        dx, dw, _ = torch.ops.aten.convolution_backward(g, x, weight, None, *geometry,
                                                        [True, True, False])
        return out, dw, dx

    want = f64(xs, w, gy, bias)
    scale = f64(xs.abs(), w.abs(), gy.abs(), bias.abs())
    errs = [float(((g.double().cpu() - t).abs() / s.clamp(min=1e-30)).max())
            for g, t, s in zip(got, want, scale)]
    err_tf32 = float(((tf32.double().cpu() - want[0]).abs() / scale[0].clamp(min=1e-30)).max())
    assert max(errs) < DENSE_CONV_TOL, errs
    print(f"{tag} with the process's TF32 flags on, the grid conv stays float32: largest "
          f"|error| / Σ|terms| against float64 {errs[0]:.3g} forward, {errs[1]:.3g} weight "
          f"gradient, {errs[2]:.3g} input gradient (F.conv2d under those flags: "
          f"{err_tf32:.3g} forward)", flush=True)
    return out


def run_z(tag="Z"):
    """SingleEndedZCNN.json as shipped (150-sample pairs: 300 features,
    conv 300→150 3×3, masked BatchNorm over the dilated occupancy, ReLU,
    conv 150→1, ReLU, the dense [B, 1, 14, 11] map), seeded random weights:
    the grid ops timed, 4 serving chunks of 4096 events, and 2 epochs × 4
    steps of ``Trainer.fit`` (L1, SGD with nesterov, ExponentialLR) against
    a CPU run. Returns the training blocks for the CLI."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import segment_block

    cfg = load_config(CONFIG_Z)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED + 20)
    chunks = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="z")
              for _ in range(N_CHUNKS)]
    state = seeded_state(cfg, SEED + 21, chunks[0])
    inputs = [(b.coords, b.feats) for b in chunks]
    check_dense_convs(cfg, state, inputs[0], tag)
    serving = run_segment_serving(cfg, state, inputs, tag)
    train = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="z")
             for _ in range(TRAIN_CHUNKS)]
    val = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="z")
           for _ in range(VAL_CHUNKS)]
    training = run_segment_training(cfg, state, train, val, tag, reference="cpu")
    assert not any(serving.values()) and not any(training.values())
    return train, val


def run_segq(tag="SegQuantifier"):
    """SegQuantifier.json as shipped (65-sample pairs: SubM 130→156→78→1,
    each 3×3 with masked BatchNorm and ReLU, on the row path; SE-only MSE on
    E), seeded random weights: K1 and K4 at its three convs against their
    plain versions (K4 bitwise over two runs, too), 4 serving chunks of
    4096 events, and 2 epochs × 4 steps of ``Trainer.fit`` against the
    plain versions' run. Returns the kernels' numbers and the training
    run's launches."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import segment_block
    from waveformml_tpu_torch.engineering.tasks import LitSegQuantifier

    cfg = load_config(CONFIG_SEGQ)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED + 30)
    chunks = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="ez")
              for _ in range(N_CHUNKS)]
    state = seeded_state(cfg, SEED + 31, chunks[0])
    task = LitSegQuantifier(cfg)
    task.model.load_state_dict(state)
    db = prepared(task, FileBlock(chunks[0].coords, chunks[0].feats, chunks[0].labels))
    convs = [tuple(m.weight.shape) for m in task.model.stack.modules() if hasattr(m, "plain")]
    print(f"{tag} stack: {convs}", flush=True)
    results = {"subm_conv_rows": check_subm_conv_rows(task.model, db, db["feats"],
                                                      tag=f"{tag} ")}
    results["subm_conv_rows_wgrad"], d_feats_err = check_subm_conv_rows_wgrad(
        task.model, db, db["feats"], tag=f"{tag} ")
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_feats_err)
    serving = run_segment_serving(cfg, state, [(b.coords, b.feats) for b in chunks], tag)
    train = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="ez")
             for _ in range(TRAIN_CHUNKS)]
    val = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="ez")
           for _ in range(VAL_CHUNKS)]
    training = run_segment_training(cfg, state, train, val, tag, reference="plain")
    a_step = training_launches(task.model, 1, 0)
    for name, r in results.items():
        assert serving[name] > 0 or name == "subm_conv_rows_wgrad", serving
        assert training[name] > 0, training
        print(f"{tag} {name}: ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f} "
              f"max_abs_err={r['max_abs_err']:.3g}; launches in the serving run "
              f"{serving[name]}, a training step {a_step[name]}, in the training run "
              f"{training[name]}", flush=True)
    return results, training


def run_sparse_nets(tag="OPs3ns_SCNet"):
    """The sparse event classifiers as shipped, from seeded random weights
    and head biases (BatchNorm statistics of one train-mode forward), over
    4096-event chunks of both particle kinds. OPs3ns_SCNet.json (the
    slice's main path: SubM 130→32 with BatchNorm and ReLU, SubM 32→8 with
    ReLU, in row space; ToDense; Linear 1232→32, ReLU, Linear 32→2): K1 at
    both convs and as the second one's d_feats, K4 at both (Cin + 1 = 131,
    33; bitwise over two runs) against their plain versions; 4 chunks
    served (logits held to the plain versions on the card and a CPU run),
    2 epochs × 4 steps of ``Trainer.fit`` held to the plain versions' run,
    every launch count asserted against the count its code derives. Then
    GEP.json, IoniClassifierCNN.json and DensePSD.json on the dense grid
    (cuDNN in float32): 4 chunks served, the first held to a CPU run over
    every event; 2 epochs × 4 steps, the steps of two blocks each held to a
    CPU step from the card's state; no kernel launched. Returns OPs3ns's
    kernel numbers, its training launches, its state and its blocks."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import labelled_block
    from waveformml_tpu_torch.engineering.tasks import LitPSD

    cfg = load_config(CONFIG_OPS)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED + 90)
    chunks = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(N_CHUNKS)]
    state = seeded_state(cfg, SEED + 91, chunks[0])
    task = LitPSD(cfg)
    task.model.load_state_dict(state)
    db = prepared(task, FileBlock(chunks[0].coords, chunks[0].feats, chunks[0].labels))
    convs = [tuple(m.weight.shape) for m in task.model.stack.modules() if hasattr(m, "plain")]
    print(f"{tag} stack: row path {task.model.row_path}, convs {convs}, specs "
          f"{task.model.stack.specs}; head input {task.model.n_linear}; rows of the first "
          f"chunk {int(db['mask'].sum())} in a bucket of {db['mask'].shape[0]}", flush=True)
    results = {"subm_conv_rows": check_subm_conv_rows(task.model, db, db["feats"],
                                                      tag=f"{tag} ")}
    results["subm_conv_rows_wgrad"], d_feats_err = check_subm_conv_rows_wgrad(
        task.model, db, db["feats"], tag=f"{tag} ")
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_feats_err)
    inputs = [(b.coords, b.feats) for b in chunks]
    serving = run_segment_serving(cfg, state, inputs, tag)
    train = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(TRAIN_CHUNKS)]
    val = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(VAL_CHUNKS)]
    training = run_segment_training(cfg, state, train, val, tag, reference="plain")
    a_forward = training_launches(task.model, 0, 1)
    a_step = training_launches(task.model, 1, 0)
    calls = len(convs)
    for name, r in results.items():
        assert serving[name] > 0 or name == "subm_conv_rows_wgrad", serving
        assert training[name] > 0, training
        print(f"{tag} {name}: ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f} "
              f"max_abs_err={r['max_abs_err']:.3g}; launches (grids, as the wrapper counts "
              f"them) derived from the code: a forward {a_forward[name]}, a training step "
              f"{a_step[name]}; counted: in the serving run {serving[name]} "
              f"({N_CHUNKS} replays), in the training run {training[name]}", flush=True)
    print(f"{tag}: K1 is called {calls} times a forward (each 3x3 conv launches its "
          f"centre-tap grid and its other taps' grid), once more a training step as the "
          f"second conv's d_feats; K4 once a conv a step (two grids)", flush=True)

    for path in CONFIGS_GRID_NETS:
        run_grid_net(path, SEED + 100 + CONFIGS_GRID_NETS.index(path))
    return results, training, state, train, val


def run_grid_net(path: str, seed: int, make_block=None):
    """A grid event classifier as shipped (no hand-written kernel on its
    path), from seeded random weights: 4 serving chunks of 4096 events
    (``make_block(rng, events, samples)``, ``labelled_block`` by default),
    the first held to a CPU run over every event, its device forward by
    kernel, and 2 epochs × 4 steps of
    ``Trainer.fit``, the first GRID_STEP_CHECKS blocks' steps each held to
    a CPU step from the card's state; no kernel launched in either.
    Returns the state, the training and the validation blocks."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block
    from waveformml_tpu_torch.engineering.tasks import LitPSD

    make_block = make_block or labelled_block
    tag = os.path.basename(path)[:-5]
    t_start = time.perf_counter()
    cfg = load_config(path)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(seed)
    chunks = [make_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(N_CHUNKS)]
    state = seeded_state(cfg, seed + 1, chunks[0])
    net = cfg.net_config.net_class
    print(f"{tag}: {net} at {n_samples} samples, "
          f"{sum(v.numel() for v in state.values())} parameters and statistics", flush=True)
    serving = run_segment_serving(cfg, state, [(b.coords, b.feats) for b in chunks], tag,
                                  cpu_events=None)
    # where a forward's device time goes, by kernel (torch.profiler)
    task = LitPSD(cfg)
    task.model.load_state_dict(state)
    db = prepared(task, chunks[0])
    kernels = sorted(grid_times_ms(lambda: task.apply_model(db), reps=5).items(),
                     key=lambda kv: -kv[1])
    print(f"{tag} forward by kernel (ms a forward, torch.profiler over 5 eager forwards, "
          f"the largest 8 of {len(kernels)}): "
          + "; ".join(f"{k} {v:.4f}" for k, v in kernels[:8])
          + f"; all {sum(v for _, v in kernels):.4f}", flush=True)
    train = [make_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(TRAIN_CHUNKS)]
    val = [make_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(VAL_CHUNKS)]
    training = run_segment_training(cfg, state, train, val, tag, reference="steps")
    assert not any(serving.values()) and not any(training.values()), (serving, training)
    print(f"{tag}: no kernel launched in serving or training ({serving}, {training}); "
          f"the config's phase took {time.perf_counter() - t_start:.1f} s", flush=True)
    return state, train, val


def waveform_chunk(rng, n: int, n_samples: int):
    """A chunk of exactly ``n`` single waveforms (``waveform_block``'s rows:
    coords ``[n]`` detector channel ids, z labels), as
    ``PulseDatasetWaveformNorm`` gives them."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import waveform_block

    block = waveform_block(rng, n + n // 4, n_samples)
    assert block.coords.shape[0] >= n, block.coords.shape
    return FileBlock(block.coords[:n], block.feats[:n], block.labels[:n])


def run_waveform_serving(cfg, state, chunks, tag, spread_tol=None) -> dict:
    """A waveform net served through ``InferenceModel`` on the card, its
    chunks' coords the per-waveform detector ids ``[N]`` (N events): each
    chunk one packed copy in, one replay of its layout's CUDA graph and a
    copy out; no kernel launched; waveforms/s, where the wall goes, the
    serving graph's replay (the device forward), the device's busy share
    and the peak device memory; the outputs held to the eager forward and
    the first chunk's to a CPU run of the port from the same state (and,
    with ``spread_tol``, within that fraction of the outputs' standard
    deviation). Returns the launches."""
    from waveformml_tpu_torch.inference.model import InferenceModel

    server = InferenceModel(cfg, state)
    task = server.task
    t0 = time.perf_counter()
    server(chunks[0].coords, chunks[0].feats)
    torch.cuda.synchronize()
    print(f"{tag} first chunk (capture of its layout): {time.perf_counter() - t0:.3f} s",
          flush=True)
    server.dispatch_phases = dict.fromkeys(server.dispatch_phases, 0.0)
    for g in server.graphs.values():
        g.replays = 0
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handles = [server.dispatch(b.coords, b.feats) for b in chunks]
    outs = [server.fetch(h) for h in handles]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eager, replayed = read_counts(), server.replay_launches()
    launches = {k: eager[k] + replayed[k] for k in eager}
    assert not any(launches.values()), launches
    assert sum(g.replays for g in server.graphs.values()) == N_CHUNKS
    served_ms = [replay_time_ms(g.graph) for g in server.graphs.values()]
    busy = sum(ms * g.replays for ms, g in zip(served_ms, server.graphs.values()))
    n_rows = sum(b.coords.shape[0] for b in chunks)
    names = {"host_prep_s": "host prep (pad, pack)", "h2d_s": "copy in",
             "launch_s": "replay + copy out", "fetch_s": "fetch"}
    phases = "; ".join(f"{names[k]} {v * 1e3 / N_CHUNKS:.3f} ({v / wall:.1%})"
                       for k, v in server.dispatch_phases.items())
    host = server.dispatch_phases["host_prep_s"] / wall
    print(f"{tag} serving: {N_CHUNKS} chunks, {n_rows} waveforms in {wall:.4f} s = "
          f"{n_rows / wall:.1f} waveforms/s; graphs {len(server.graphs)}, launches {launches}",
          flush=True)
    print(f"{tag} serving breakdown (ms/chunk, share of wall): {phases}; host share of the "
          f"wall (host prep) {host:.4f}; device forward (a replay of each serving graph) "
          f"{[round(ms, 4) for ms in served_ms]} ms; wall {wall * 1e3 / N_CHUNKS:.3f}; "
          f"device busy share {busy / (wall * 1e3):.4f}; peak device memory "
          f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    err_eager = 0.0
    for b, out in zip(chunks, outs):
        n = b.coords.shape[0]
        assert out.shape == (n, 1) and np.isfinite(out).all(), out.shape
        direct = task.apply_model(prepared(task, b))[:n].cpu().numpy()
        np.testing.assert_allclose(out, direct, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        err_eager = max(err_eager, float(np.abs(out - direct).max()))
    spread = float(np.std(np.concatenate(outs)))
    assert spread > 0, spread
    t0 = time.perf_counter()
    cpu = InferenceModel(cfg, state, device="cpu")(chunks[0].coords, chunks[0].feats)
    cpu_s = time.perf_counter() - t0
    np.testing.assert_allclose(outs[0], cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    err_cpu = float(np.abs(outs[0] - cpu).max())
    if spread_tol is not None:
        assert err_cpu <= spread_tol * spread, (err_cpu, spread)
    print(f"{tag} outputs {outs[0].shape} a chunk (std {spread:.4g}): the graph path matches "
          f"the eager forward (largest |difference| {err_eager:.3g}) and the first chunk's "
          f"{cpu.shape[0]} waveforms a CPU run of the port ({cpu_s:.2f} s; largest |difference| "
          f"{err_cpu:.3g}, {err_cpu / spread:.3g} of the std) (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}" + (f"; within {spread_tol} of the std" if spread_tol else "")
          + ")", flush=True)
    return launches


def run_waveform_nets() -> dict:
    """SingleWaveformTCN.json and SingleWaveformRNN.json as shipped (59
    samples; the TCN's planes 2, 4, 2, 1 and a 4-layer LinearBlock; two
    ReLU RNN layers of 32 and a 2-layer LinearBlock; L1 on z), from seeded
    random weights and biases: 4 chunks of 16384 waveforms served
    (``run_waveform_serving``) and 2 epochs × 4 steps of ``Trainer.fit``
    of ``LitWaveform`` (SGD nesterov, ExponentialLR), the first
    GRID_STEP_CHECKS blocks' steps each held to a CPU step from the card's
    state; the TCN's chunks served again from the weights its fit ends
    with (their outputs spread, those at init barely do), held to the CPU
    at the same tolerance and within TCN_SPREAD_TOL of their standard
    deviation; no kernel launched. Returns, by config path, its
    state and its training and validation blocks."""
    from waveformml_tpu_torch.config import load_config

    out = {}
    for i, path in enumerate(CONFIGS_WAVEFORM):
        tag = os.path.basename(path)[:-5]
        t_start = time.perf_counter()
        cfg = load_config(path)
        n_samples = cfg.system_config.n_samples
        rng = np.random.default_rng(SEED + 110 + 10 * i)
        chunks = [waveform_chunk(rng, WAVEFORMS_PER_CHUNK, n_samples) for _ in range(N_CHUNKS)]
        state = seeded_state(cfg, SEED + 111 + 10 * i, chunks[0])
        print(f"{tag}: {cfg.net_config.net_class} at {n_samples} samples, "
              f"{sum(v.numel() for v in state.values())} parameters", flush=True)
        serving = run_waveform_serving(cfg, state, chunks, tag)
        train = [waveform_chunk(rng, WAVEFORMS_PER_CHUNK, n_samples)
                 for _ in range(TRAIN_CHUNKS)]
        val = [waveform_chunk(rng, WAVEFORMS_PER_CHUNK, n_samples) for _ in range(VAL_CHUNKS)]
        trained = {}
        training = run_segment_training(cfg, state, train, val, tag, reference="steps",
                                        trained_state=trained)
        if path == CONFIGS_WAVEFORM[0]:
            # the TCN's outputs at init barely vary (std ~3e-06 a chunk), so
            # the serving check above could pass a wrong forward near that
            # constant: serve the trained weights too, whose outputs spread
            served = run_waveform_serving(cfg, trained, chunks, f"{tag} after training",
                                          spread_tol=TCN_SPREAD_TOL)
            serving = {k: serving[k] + served[k] for k in serving}
        assert not any(serving.values()) and not any(training.values()), (serving, training)
        print(f"{tag}: no kernel launched in serving or training; the config's phase took "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        out[path] = (state, train, val)
    return out


def conv3d_times(stack, grid, tag) -> dict:
    """cuDNN's conv3d of the grid stack's first SubM conv over the dense
    [B, Cin, NX, NY, T] grid (float32 without TF32), its forward and its
    weight gradient, timed as graph replays beside their bounds (float32
    operations outside the tensor cores, every site of the grid); the
    weight gradient, ~0.1 s a call, over 3 samples."""
    from waveformml_tpu_torch.ops import sparse_conv as sc

    x = grid.masked()
    w, b = stack.layers_0.conv.weight.detach(), stack.layers_0.conv.bias.detach()
    cout, cin = w.shape[:2]
    sites = x.shape[0] * int(np.prod(x.shape[2:]))
    one, pad = (1, 1, 1), (1, 1, 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 124)
    gy = torch.randn((x.shape[0], cout) + tuple(x.shape[2:]), device="cuda", generator=gen)

    def wgrad():
        with sc.ieee_fp32():
            return torch.ops.aten.convolution_backward(gy, x, w, [cout], list(one), list(pad),
                                                       list(one), False, [0, 0, 0], 1,
                                                       [False, True, True])

    out = {}
    for name, fn, n_bytes, samples in (
            ("forward", lambda: sc.conv(x, w, b, one, pad, one),
             4 * (x.numel() + w.numel() + cout + sites * cout), TIMING_SAMPLES),
            ("weight gradient", wgrad, 4 * (x.numel() + gy.numel() + w.numel() + cout), 3)):
        ms = graph_time_ms(fn, samples=samples)
        b_ms, by = bound_ms(n_bytes, 2.0 * sites * cout * cin * 27)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"{tag} cuDNN conv3d {cin}->{cout} 3x3x3 {name} over the dense grid "
              f"{tuple(x.shape)}: ms={ms:.5f} bound_ms={b_ms:.5f} ({by}, float32 at "
              f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s over every site)", flush=True)
    return out


def forced_tap_designs() -> dict:
    """K1 and K4 in each design, through their launchers directly (the ops
    run the one ops/row_conv.py row_design picks): ``{design: (k1, k4)}``,
    ``k1(feats, plan, kernel, bias, mask)`` → out, ``k4(feats, plan, g,
    mask)`` → (dW, db), on the current stream."""
    from waveformml_tpu_torch.ops import native
    from waveformml_tpu_torch.ops import row_conv as rc

    k1_lib = native.load("row_conv", rc._FUNCTIONS)
    k4_lib = native.load("row_conv_wgrad", rc._WGRAD_FUNCTIONS)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k1(launch):
        def run(feats, plan, kernel, bias, mask):
            (n, cin), (kk, _, cout) = feats.shape, kernel.shape
            out = torch.empty((n, cout), device=feats.device)
            native.check_launch(k1_lib, launch(
                feats.data_ptr(), plan.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                mask.data_ptr(), out.data_ptr(), n, cin, cout, kk, stream()), "K1")
            return out
        return run

    def k4(taps: bool):
        def run(feats, plan, g, mask):
            (n, cin), kk, cout = feats.shape, plan.shape[1], g.shape[1]
            dw = torch.empty((kk, cin, cout), device=feats.device)
            db = torch.empty(cout, device=feats.device)
            floats = ctypes.c_longlong()
            if taps:
                blocks, rows = ctypes.c_int(), ctypes.c_int()
                native.check_launch(k4_lib, k4_lib.subm_conv_rows_wgrad_taps_scratch(
                    n, cin, cout, ctypes.byref(blocks), ctypes.byref(rows),
                    ctypes.byref(floats)), "K4 scratch")
                partial = torch.empty(floats.value, device=feats.device)
                err = k4_lib.subm_conv_rows_wgrad_taps(
                    feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n, cin, cout, kk,
                    stream())
            else:
                ints = ctypes.c_longlong()
                k4_lib.subm_conv_rows_wgrad_scratch(n, cin, cout, kk, ctypes.byref(floats),
                                                    ctypes.byref(ints))
                partial = torch.empty(floats.value, device=feats.device)
                lists = torch.empty(ints.value, dtype=torch.int32, device=feats.device)
                err = k4_lib.subm_conv_rows_wgrad(
                    feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(),
                    partial.data_ptr(), lists.data_ptr(), dw.data_ptr(), db.data_ptr(), n,
                    cin, cout, kk, stream())
            native.check_launch(k4_lib, err, "K4")
            return dw, db
        return run

    return {"taps": (k1(k1_lib.subm_conv_rows_taps_fwd), k4(True)),
            "tiles": (k1(k1_lib.subm_conv_rows_fwd), k4(False))}


#: (K², Cin, Cout) of the d_feats convs --ab-k1 times: SubMPSD.json's
#: layers 1-2 (56→104, 8→56) and OPs3ns_SCNet.json's layer 1 (8→32)
AB_K1_SHAPES = ((9, 56, 104), (1, 8, 56), (9, 8, 32))


def ab_k1_main(other: str) -> int:
    """``python3 chip_smoke.py --ab-k1 DIR``: K1 of this checkout against K1
    of the checkout at DIR (another commit, built there by its own
    ``ops/native.py``), at AB_K1_SHAPES, where every commit runs K1's tiles
    design, on one 4096-event SubMPSD.json chunk (its plans built on the
    host): each shape held to the plain version with both libraries, then
    timed by graph replay in the order A, B, B, A (A this checkout). The
    same last line as ``main``."""
    if not torch.cuda.is_available():
        print("chip_smoke --ab-k1: CUDA is not available", file=sys.stderr)
        return 1
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.ops import native
    from waveformml_tpu_torch.ops import row_conv as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    built = subprocess.run(
        [sys.executable, "-c", "from waveformml_tpu_torch.ops import native; "
         "native.build(['row_conv']); print(native.library_path('row_conv'))"],
        cwd=other, capture_output=True, text=True, check=True, timeout=600)
    other_lib = ctypes.CDLL(built.stdout.strip().splitlines()[-1])
    argtypes = rc._FUNCTIONS["subm_conv_rows_fwd"]
    other_lib.subm_conv_rows_fwd.argtypes = argtypes
    other_lib.subm_conv_rows_fwd.restype = ctypes.c_int
    libs = {"A": native.load("row_conv", rc._FUNCTIONS), "B": other_lib}
    cfg = load_config(CONFIG)
    db = prepared(LitPSD(cfg), labelled_block(np.random.default_rng(SEED), EVENTS_PER_CHUNK,
                                              cfg.system_config.n_samples))
    mask = db["mask"]
    n = mask.shape[0]
    coords, mask_np = db["coords"].cpu().numpy(), mask.cpu().numpy()
    plans = {k * k: torch.from_numpy(rc.host_neighbor_plan(coords, mask_np,
                                                           db["labels"].shape[0], k)).cuda()
             for k in (1, 3)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 126)
    for kk, cin, cout in AB_K1_SHAPES:
        g = torch.where(mask[:, None], torch.randn(n, cin, device="cuda", generator=gen),
                        0.0).contiguous()
        kernel = torch.randn(kk, cin, cout, device="cuda", generator=gen) / (kk * cin) ** 0.5
        plan = plans[kk]
        want = rc.subm_conv_rows_plain(g, plan, kernel, None, mask)

        def call(lib, plan=plan, g=g, kernel=kernel, kk=kk, cin=cin, cout=cout):
            out = torch.empty((n, cout), device="cuda")
            native.check_launch(libs["A"], lib.subm_conv_rows_fwd(
                g.data_ptr(), plan.data_ptr(), kernel.data_ptr(), None, mask.data_ptr(),
                out.data_ptr(), n, cin, cout, kk, torch.cuda.current_stream().cuda_stream),
                "K1")
            return out

        for side, lib in libs.items():
            got = call(lib)
            torch.cuda.synchronize()
            max_abs_err([got], [want], TOL["subm_conv_rows"])
        times = [(side, graph_time_ms(lambda lib=libs[side]: call(lib))) for side in "ABBA"]
        print(f"--ab-k1 K²={kk} {cin}->{cout} N={n} (ms, graph replays of one call; A this "
              f"checkout, B {other}): " + ", ".join(f"{side} {ms:.5f}" for side, ms in times),
              flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tap_designs_main() -> int:
    """``python3 chip_smoke.py --tap-designs``: K1 and K4 at 27 taps in both
    designs (``forced_tap_designs``) over phase 11's plan (SCNet3D.json's
    first 4096-event chunk, as its task buckets it), at each of
    TAP_DESIGN_WIDTHS (Cin, Cout) on random operands: each against its
    plain version (K1 within TOL, K4 within TOL of its terms' magnitudes)
    and timed (graph replays of one call) beside the library candidates,
    each with its device time by kernel: the measurements behind
    ops/row_conv.py row_design and the library lines. The same last line
    as ``main``."""
    if not torch.cuda.is_available():
        print("chip_smoke --tap-designs: CUDA is not available", file=sys.stderr)
        return 1
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block_3d
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.ops import native
    from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows_plain,
                                                   subm_conv_rows_wgrad_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    native.build()
    cfg = load_config(CONFIG_3D)
    n_t = cfg.system_config.n_samples
    task = LitPSD(cfg)
    block = labelled_block_3d(np.random.default_rng(SEED + 120), EVENTS_PER_CHUNK, n_t)
    db = prepared(task, block)
    mask = db["mask"]
    plan = torch.from_numpy(host_neighbor_plan(db["coords"].cpu().numpy(), mask.cpu().numpy(),
                                               db["labels"].shape[0], 3, n_t)).cuda()
    n = mask.shape[0]
    print(f"--tap-designs: plan {tuple(plan.shape)}, real rows {int(mask.sum())}, row-taps "
          f"{int(((plan >= 0) & mask[:, None]).sum())}", flush=True)
    designs = forced_tap_designs()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 125)
    for cin, cout in TAP_DESIGN_WIDTHS:
        feats = torch.where(mask[:, None], torch.randn(n, cin, device="cuda", generator=gen),
                            0.0).contiguous()
        g = torch.where(mask[:, None], torch.randn(n, cout, device="cuda", generator=gen),
                        0.0).contiguous()
        kernel = torch.randn(27, cin, cout, device="cuda", generator=gen) / (27 * cin) ** 0.5
        bias = torch.randn(cout, device="cuda", generator=gen)
        args = (feats, plan, kernel, bias, mask)
        want = subm_conv_rows_plain(*args)
        wgrad_want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
        scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
        times = {}
        for design, (k1, k4) in designs.items():
            got, wgrad = k1(*args), k4(feats, plan, g, mask)
            torch.cuda.synchronize()
            max_abs_err([got], [want], TOL["subm_conv_rows"])
            close_to_terms(wgrad, wgrad_want, scale, TOL["subm_conv_rows_wgrad"],
                           f"K4 {design} {cin}x{cout}")
            times[f"K1 {design}"] = graph_time_ms(lambda: k1(*args))
            times[f"K4 {design}"] = graph_time_ms(lambda: k4(feats, plan, g, mask))
        tag = f"--tap-designs {cin}->{cout}"
        times["K1 library"] = fastest_library_ms(k1_library(*args), f"{tag} K1", profile=True)
        times["K4 library"] = fastest_library_ms(k4_library(feats, plan, g, mask, True),
                                                 f"{tag} K4", profile=True)
        print(f"{tag} (ms, graph replays of one call; both designs against the plain "
              f"versions): " + ", ".join(f"{k} {v:.5f}" for k, v in times.items()), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_scnet3d_rows(cfg, state, block, tag="SCNet3D rows"):
    """SCNet3D.json's sparse section (SubM 2→8, BatchNorm, ReLU, ToDense)
    in row space, ``DSLSpecNet(n_t=16)`` (K1 forward, K4 in the backward,
    at 27 taps), its SubM weights and BatchNorm carried over from the grid
    net's ``state``, on one 4096-event chunk: its eval grid held to the
    grid stack's (cuDNN's conv3d) at every occupied site; a train-mode
    forward and backward, every kernel's count set to 0 just before and
    read just after (asserted against the count the code derives), held to
    the plain versions on the card; K1 (2→8) and K4 (Cin + 1 = 3) against
    their plain versions with their times, bounds and library times, K1
    also as the d_feats of a second conv, 8→8, K1 in both and K4 bitwise
    equal over two runs, beside cuDNN's conv3d of the same layer over the
    dense grid and the tiles design's times (PERF.md). Returns K1's and
    K4's numbers and the launches of the forward and backward."""
    from types import SimpleNamespace

    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.models.algorithm import dsl_to_row_specs, split_algorithm
    from waveformml_tpu_torch.models.sparse_blocks import DSLSpecNet
    from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows,
                                                   subm_conv_rows_bwd_plain,
                                                   subm_conv_rows_plain, transposed_kernel)
    from waveformml_tpu_torch.ops.sparse import SparseBatch, occupancy_mask_3d
    from waveformml_tpu_torch.ops.sparse_conv import batch_to_grid_3d

    n_t = cfg.system_config.n_samples
    task = LitPSD(cfg)
    task.model.load_state_dict(state)
    task.model.eval()
    db = prepared(task, block)
    n_events = db["labels"].shape[0]
    specs = dsl_to_row_specs(split_algorithm(cfg.net_config.algorithm)[1])
    net = DSLSpecNet(specs, n_t=n_t,
                     generator=torch.Generator().manual_seed(SEED + 121)).to("cuda")
    stack = task.model.sparse_model
    conv, bn = stack.layers_0.conv, stack.layers_1
    cout, cin = conv.weight.shape[:2]
    with torch.no_grad():
        # [Cout, Cin, kx, ky, kt] → taps (dx, dy, dt) row-major, [27, Cin, Cout]
        net.l0.weight.copy_(conv.weight.permute(2, 3, 4, 1, 0).reshape(27, cin, cout))
        net.l0.bias.copy_(conv.bias)
    net.l1.load_state_dict(bn.state_dict())
    coords, mask = db["coords"].cpu().numpy(), db["mask"].cpu().numpy()
    plan = torch.from_numpy(host_neighbor_plan(coords, mask, n_events, 3, n_t)).cuda()
    batch = SparseBatch(db["coords"], db["feats"], db["mask"], n_events,
                        plans={net.l0.plan_key: plan})
    grid = batch_to_grid_3d(batch, n_t)
    print(f"{tag}: specs {net.specs}, plan {tuple(plan.shape)} ({net.l0.plan_key}); rows "
          f"{int(db['mask'].sum())} in a bucket of {db['mask'].shape[0]}, occupied sites "
          f"{int(grid.occupancy.sum())} of {grid.occupancy.numel()} "
          f"({float(grid.occupancy.float().mean()):.4%})", flush=True)

    net.eval()
    with torch.no_grad():
        rows = net(batch)
        dense = stack(grid)
    occ = occupancy_mask_3d(batch, n_t)[:, None].expand_as(rows)
    torch.testing.assert_close(rows[occ], dense[occ], rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert float(rows[~occ].abs().max()) == 0.0
    print(f"{tag}: the row stack's grid matches the dense SubMConv3d stack's at all "
          f"{int(occ.sum())} occupied (site, channel) entries (largest |difference| "
          f"{float((rows[occ] - dense[occ]).abs().max()):.3g}; rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}), zero elsewhere", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 122)
    g = torch.randn(rows.shape, device="cuda", generator=gen) / rows.numel() ** 0.5

    def forward_backward(model):
        model = copy.deepcopy(model).train()
        out = model(batch)
        (out * g).sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    zero_counts()
    got_out, got_grads = forward_backward(net)
    torch.cuda.synchronize()
    launches = read_counts()
    want_launches = training_launches(net, 1, 0)
    assert launches == want_launches, (launches, want_launches)
    plain = copy.deepcopy(net)
    set_plain(plain, True)
    want_out, want_grads = forward_backward(plain)
    torch.testing.assert_close(got_out, want_out, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    largest = max(float(v.abs().max()) for v in want_grads.values())
    ratios = []
    for name, want in want_grads.items():
        if name == "l0.bias":
            # before the BatchNorm its gradient is zero but for rounding (a
            # cancelling sum over ~10^5 rows): each run's far below a
            # trained gradient, the two roundings not compared
            moved = max(float(got_grads[name].abs().max()), float(want.abs().max()))
            assert moved <= GRAD_ATOL * largest, (name, moved, largest)
            ratios.append(f"{name} (rounding) {moved / largest:.3g} of the largest")
            continue
        scale = float(want.abs().max())
        torch.testing.assert_close(got_grads[name], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")
        ratios.append(f"{name} {float((got_grads[name] - want).abs().max()) / scale:.3g}")
    print(f"{tag}: a train-mode forward and backward with the kernels (launches {launches}, "
          f"as derived from the code) match the plain versions' on the card: outputs "
          f"(rtol={LOGIT_RTOL}, atol={LOGIT_ATOL}), every gradient (rtol={GRAD_RTOL}, "
          f"atol={GRAD_ATOL}·its largest |value|; l0.bias, before the BatchNorm, each run's "
          f"within {GRAD_ATOL}·{largest:.4g}); largest |difference| / scale: "
          f"{'; '.join(ratios)}", flush=True)

    feats0 = db["feats"].float().contiguous()
    kdb = {"mask": db["mask"], f"plan_{net.l0.plan_key}": plan}
    results = {"subm_conv_rows": check_subm_conv_rows(SimpleNamespace(stack=net), kdb, feats0,
                                                      tag=f"{tag} ")}
    results["subm_conv_rows_wgrad"], _ = check_subm_conv_rows_wgrad(
        SimpleNamespace(stack=net), kdb, feats0, tag=f"{tag} ")
    # K1 at 27 taps gives the same bits twice (the taps design has no atomics)
    check_bitwise(lambda: [subm_conv_rows(feats0, plan, net.l0.weight.detach(),
                                          net.l0.bias.detach(), db["mask"])],
                  f"{tag} K1 2->8")
    # K1 as the feature gradient of a second conv, 8→8 (the reversed,
    # transposed kernel) against the plain _subm_bwd d_feats
    gen = torch.Generator(device="cuda").manual_seed(SEED + 123)
    mask = db["mask"]
    n = mask.shape[0]
    weight = torch.randn(27, cout, cout, device="cuda", generator=gen) / (27 * cout) ** 0.5
    x8 = torch.where(mask[:, None], torch.relu(torch.randn(n, cout, device="cuda",
                                                           generator=gen)), 0.0).contiguous()
    g8 = torch.where(mask[:, None], torch.randn(n, cout, device="cuda",
                                                generator=gen), 0.0).contiguous()
    w_t = transposed_kernel(weight)
    d_feats = subm_conv_rows(g8, plan, w_t, None, mask)
    d_want = subm_conv_rows_bwd_plain(x8, plan, weight, mask, g8)[0]
    torch.cuda.synchronize()
    d_err = max_abs_err([d_feats], [d_want], TOL["subm_conv_rows"])
    check_bitwise(lambda: [subm_conv_rows(g8, plan, w_t, None, mask)], f"{tag} K1 d_feats")
    needed = int(((plan >= 0) & mask[:, None]).sum())
    n_real = int(mask.sum())
    # g and the plan over the real rows, mask and W read once, d_feats
    # written once over all N
    d_bytes = 4 * (n_real * cout + n_real * 27 + 27 * cout * cout + n * cout) + n
    d_bound, d_by = bound_ms(d_bytes, *row_conv_ops(27, cout, cout, needed))
    d_args = (g8, plan, w_t, None, mask)
    d_feats_r = dict(
        ms=graph_time_ms(lambda: subm_conv_rows(*d_args)),
        plain_ms=graph_time_ms(lambda: subm_conv_rows_plain(*d_args)),
        library_ms=fastest_library_ms(k1_library(*d_args),
                                      f"{tag} K1 as d_feats {cout}->{cout}", profile=True),
        bound_ms=d_bound, bound_by=d_by, max_abs_err=d_err)
    print(f"{tag} K1 as d_feats of a second conv {cout}->{cout} at 27 taps: "
          f"ms={d_feats_r['ms']:.5f} max_abs_err={d_err:.3g} against the plain d_feats, "
          f"bitwise equal over two runs", flush=True)
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_err)
    dense_ms = conv3d_times(stack, grid, tag)
    for name, r in (("subm_conv_rows", results["subm_conv_rows"]),
                    ("subm_conv_rows d_feats", d_feats_r),
                    ("subm_conv_rows_wgrad", results["subm_conv_rows_wgrad"])):
        kernel = name.split()[0]
        print(f"{tag} {name} at 27 taps: ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.5f} library_ms="
              f"{r['library_ms']:.5f} max_abs_err={r['max_abs_err']:.3g}; the tiles design "
              f"{TILES_27_TAPS_MS[name]:.5f} (PERF.md); launches of the forward "
              f"and backward {launches[kernel]}; beside it cuDNN's conv3d over the dense "
              f"grid: {dense_ms['weight gradient' if kernel.endswith('wgrad') else 'forward']}",
              flush=True)
    return results, launches


def run_scnet3d():
    """SCNet3D.json as shipped (T = 16 samples: SubMConv3d 2→8, BatchNorm,
    ReLU, ToDense, Linear 19712→32→2) on the dense grid, from seeded random
    weights and biases: ``run_grid_net`` over chunks of 4096 events of both
    kinds as ``PulseDataset3D`` gives them (the (x, y, t) rows where a PMT
    clears the threshold), then its sparse section in row space
    (``run_scnet3d_rows``). Returns the row path's kernel numbers and
    launches, the state and the training and validation blocks."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block_3d

    state, train, val = run_grid_net(CONFIG_3D, SEED + 120, make_block=labelled_block_3d)
    results, launches = run_scnet3d_rows(load_config(CONFIG_3D), state, val[0])
    return results, launches, state, train, val


def kernels_per_call(fn, grad_input=None, calls: int = 3) -> tuple:
    """The device kernels one ``fn()`` call launches: the kernel records of
    a torch.profiler trace over ``calls`` calls, divided by ``calls``, and
    their names; with ``grad_input``, a tensor fn reads, also those of the
    backward to it (from a gradient of ones made beforehand, its ``grad``
    unset as a training step leaves it)."""
    from torch.profiler import ProfilerActivity, profile

    if grad_input is not None:
        grad_input.requires_grad_(True)
    grad = torch.ones_like(fn()) if grad_input is not None else None

    def call():
        out = fn()
        if grad_input is not None:
            grad_input.grad = None
            out.backward(grad)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    if grad_input is not None:
        grad_input.requires_grad_(False)
        grad_input.grad = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = sorted({kernel_name(e["name"]) for e in events if e.get("cat") == "kernel"})
    n = sum(1 for e in events if e.get("cat") == "kernel")
    return n // calls, names


def graph_edge_build(chunks, k: int) -> None:
    """The kNN edges of each serving chunk built on the host by the C++
    library (``ops.graph.knn_graph``, built by g++ in this run), timed a
    chunk, the first chunk's held to the numpy plain version, edge for
    edge."""
    from waveformml_tpu_torch.ops import graph, native

    t0 = time.perf_counter()
    graph.library()
    load_s = time.perf_counter() - t0
    built = native.HOST_BUILDS.get("window_edges")
    how = (f"built by g++ ({' '.join(native.GXX_FLAGS)}) in {built:.2f} s" if built is not None
           else f"loaded as built before ({load_s:.2f} s)")
    print(f"graph edges: the C++ library {native.host_library_path('window_edges')} {how}; "
          f"the numpy plain version did not run in its place", flush=True)
    times, counts, first = [], [], None
    for b in chunks:
        pos, batch = b.coords[:, :2].astype(np.float64), b.coords[:, 2].astype(np.int64)
        t0 = time.perf_counter()
        edges = graph.knn_graph(pos, k, batch)
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(edges.shape[1])
        first = edges if first is None else first
    b = chunks[0]
    t0 = time.perf_counter()
    plain = graph.knn_graph_numpy(b.coords[:, :2], k, b.coords[:, 2])
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert np.array_equal(plain, first)
    sizes = np.bincount(b.coords[:, 2])
    print(f"graph edges: kNN (k = {k}) of {N_CHUNKS} chunks on the host (C++, OpenMP): "
          f"{[round(t, 3) for t in times]} ms a chunk, {counts} edges; rows an event up to "
          f"{sizes.max()} (mean {sizes.mean():.2f}); the first chunk's edges equal the numpy "
          f"plain version's, edge for edge ({plain_ms:.1f} ms)", flush=True)


def knn_sets(edges, mask) -> dict:
    sets = {}
    for s, d in zip(*np.asarray(edges)[:, np.asarray(mask)]):
        sets.setdefault(int(d), set()).add(int(s))
    return sets


def check_feature_knn(db, k: int) -> None:
    """``feature_knn`` on a prepared chunk's features on the card, against
    the CPU run over the same inputs under the near-tie rule of
    tests/test_parity_graph_torch.py: each centre's live neighbour set
    equal, or differing only between candidates whose float64 distances
    agree to 1e-5 relative. Prints its time (eager, CUDA events, its host
    synchronisation included), the peak device memory above what was
    allocated before, and its bound."""
    from waveformml_tpu_torch.models.graph_layers import feature_knn

    x, batch, mask = db["feats"], db["coords"][:, 2], db["mask"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    edges, live = feature_knn(x, batch, mask, k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    samples = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        feature_knn(x, batch, mask, k)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    ms = statistics.median(samples)
    t0 = time.perf_counter()
    cpu_edges, cpu_live = feature_knn(x.cpu(), batch.cpu(), mask.cpu(), k)
    cpu_s = time.perf_counter() - t0
    got, want = knn_sets(edges.cpu(), live.cpu()), knn_sets(cpu_edges, cpu_live)
    x64 = x.double().cpu().numpy()
    tied = 0
    for c in set(got) | set(want):
        a, b = got.get(c, set()), want.get(c, set())
        if a != b:
            d64 = [float(np.sum((x64[c] - x64[j]) ** 2)) for j in a ^ b]
            assert max(d64) - min(d64) <= 1e-5 * max(max(d64), 1e-30), (c, a, b, d64)
            tied += 1
    n, f = x.shape
    m = mask.cpu().numpy()
    sizes = np.bincount(batch.cpu().numpy()[m])
    n_bytes = n * f * 4 + n * 4 + n + 2 * n * k * 4 + n * k
    # each event's pairs: a difference, a square and an add a feature
    b_ms, by = bound_ms(n_bytes, 3.0 * f * float((sizes.astype(np.float64) ** 2).sum()))
    print(f"graph feature_knn (k = {k}) on {int(m.sum())} rows x {f} features of "
          f"{len(sizes)} events (bucket {n}): {ms:.4f} ms (eager, CUDA events, its host "
          f"synchronisation included), bound {b_ms:.6f} ms ({by}); peak device memory "
          f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB allocated before "
          f"(torch.cuda.max_memory_allocated); its live edges match the CPU run's ({cpu_s:.2f} "
          f"s) at every centre but {tied} near-ties (float64 distances within 1e-5 relative)",
          flush=True)


def graph_op_table(task, db) -> None:
    """The graph family's device ops as the port runs them on the card, at
    IoniClassifierGraph.json's shapes over a prepared chunk: each op's time
    (a CUDA graph of one call, replayed), its bound (bytes each input read
    once and each output written once, or float32 operations), and its
    kernel launches a serving replay and a training step (the kernels one
    call launches, forward or forward and backward, times its calls a
    forward from the code). Prints one line an op."""
    from waveformml_tpu_torch.models.graph_layers import (edge_softmax, global_max_pool,
                                                          segment_mean, segment_sum)

    net = task.model
    x, mask = db["feats"], db["mask"]
    n, n_events = x.shape[0], db["labels"].shape[0]
    edges, live = db[f"edges_knn{net.k}"], db[f"edge_mask_knn{net.k}"]
    n_edges = edges.shape[1]
    src, dst = edges[0], edges[1]
    widths = [net.gconv_0.lin_l.in_features, net.gconv_1.lin_l.in_features]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)

    def row(name, fn, grad_input, n_bytes, flops, calls):
        ms = graph_time_ms(fn)
        b_ms, by = bound_ms(n_bytes, flops)
        fwd, names = kernels_per_call(fn)
        both, _ = kernels_per_call(fn, grad_input)
        print(f"graph op {name}: {ms:.5f} ms (CUDA graph replay), bound {b_ms:.6f} ms ({by}); "
              f"{fwd} kernels a call ({names}), {both} with its backward; {calls} calls a "
              f"forward: {calls * fwd} launches a serving replay, {calls * both} a training "
              f"step", flush=True)

    for i, f in enumerate(widths):
        h = torch.randn(n, f, device="cuda", generator=gen)
        msg = h[src]
        row(f"gather x[src] (conv {i}, {f} wide)", lambda h=h: h[src], h,
            n * f * 4 + n_edges * 8 + n_edges * f * 4, 0.0, 1)
        row(f"segment_mean (conv {i}, {f} wide)", lambda m=msg: segment_mean(m, dst, n, live),
            msg, n_edges * f * 4 + n_edges * 8 + n_edges + n * f * 4,
            float(n_edges * f + n_edges + n * f), 1)
    f = widths[0]
    msg = torch.randn(n_edges, f, device="cuda", generator=gen)
    row(f"segment_sum ({f} wide)", lambda: segment_sum(msg, dst, n, live), msg,
        n_edges * f * 4 + n_edges * 8 + n_edges + n * f * 4, float(n_edges * f), 0)
    logits = torch.randn(n_edges, 1, device="cuda", generator=gen)
    row("edge_softmax (one head)", lambda: edge_softmax(logits, dst, n, live), logits,
        2 * n_edges * 4 + n_edges * 8 + n_edges, 5.0 * n_edges, 0)
    out = net.graph_out
    pooled_in = torch.randn(n, out, device="cuda", generator=gen)
    batch = db["coords"][:, 2]
    row(f"global_max_pool (segment_max, {out} wide)",
        lambda: global_max_pool(pooled_in, batch, n_events, mask), pooled_in,
        n * out * 4 + n * 4 + n + n_events * out * 4, float(n * out), 1)


def run_graph():
    """The graph family on the card. IoniClassifierGraph.json as shipped
    (``LitPSD`` + ``GraphNet``: SAGEConv 130→73→16, k = 4, masked
    BatchNorm, a max pool over each event, LinearBlock 16→2), from seeded
    random weights and biases, over chunks of 4096 events of up to
    GRAPH_MAX_MULT rows: the host edge build (C++) a chunk; 4 chunks
    served through ``InferenceModel`` (a CUDA graph per row bucket and
    edge cap) with the first held to a CPU run over every event, the
    forward by kernel (torch.profiler), events/s and the busy share; 2
    epochs × 4 steps of ``Trainer.fit`` over the serving chunks, the first
    GRID_STEP_CHECKS blocks' steps each held to a CPU step from the card's
    state (``index_add``'s atomics reorder the float32 sums); the graph
    ops' table; ``feature_knn`` on a chunk against the CPU's; then
    ``GraphZNet`` under ``LitZ`` (65 samples, GRAPH_Z_HPARAMS) served the
    same way and trained 2 epochs × 2 steps. No hand-written kernel
    launches. Returns the IoniClassifierGraph state and its training and
    validation blocks."""
    from waveformml_tpu_torch.config import Config, load_config, to_dict, validate_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block, segment_block
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.models.graph_net import GraphZNet

    t_start = time.perf_counter()
    zero_counts()
    tag = "IoniClassifierGraph"
    cfg = load_config(CONFIG_GRAPH)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED + 160)
    chunks = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples, max_mult=GRAPH_MAX_MULT)
              for _ in range(N_CHUNKS)]
    k = cfg.net_config.hparams.k
    graph_edge_build(chunks, k)
    state = seeded_state(cfg, SEED + 161, chunks[0])
    print(f"{tag}: {cfg.net_config.net_class} at {n_samples} samples, "
          f"{sum(v.numel() for v in state.values())} parameters and statistics", flush=True)
    serving = run_segment_serving(cfg, state, [(b.coords, b.feats) for b in chunks], tag,
                                  cpu_events=None)
    task = LitPSD(cfg)
    task.model.load_state_dict(state)
    db = prepared(task, chunks[0])
    kernels = sorted(grid_times_ms(lambda: task.apply_model(db), reps=5).items(),
                     key=lambda kv: -kv[1])
    print(f"{tag} forward by kernel (ms a forward, torch.profiler over 5 eager forwards, "
          f"the largest 8 of {len(kernels)}): "
          + "; ".join(f"{name} {v:.4f}" for name, v in kernels[:8])
          + f"; all {sum(v for _, v in kernels):.4f}", flush=True)
    # the serving chunks train too (a 4096-event block takes ~2 s to make)
    train = chunks[:TRAIN_CHUNKS]
    val = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples, max_mult=GRAPH_MAX_MULT)
           for _ in range(VAL_CHUNKS)]
    training = run_segment_training(cfg, state, train, val, tag, reference="steps")
    graph_op_table(task, db)
    check_feature_knn(db, k)

    z_tag = "GraphZNet (LitZ)"
    d = to_dict(cfg)
    d["run_config"].update(exp_name="GraphZ", run_class="LitZ")
    d["net_config"].update(net_class="GraphNet.GraphZNet", net_type="graph",
                           criterion_class="L1Loss", hparams=dict(GRAPH_Z_HPARAMS))
    d["system_config"]["model_name"] = "GraphZ"
    z_cfg = validate_config(Config(d))
    z_chunks = [segment_block(rng, EVENTS_PER_CHUNK, n_samples, label="z",
                              max_mult=GRAPH_MAX_MULT) for _ in range(N_CHUNKS)]
    z_state = seeded_state(z_cfg, SEED + 162, z_chunks[0])
    print(f"{z_tag}: {GRAPH_Z_HPARAMS} at {n_samples} samples, edges "
          f"{GraphZNet(z_cfg).edge_requirements()}", flush=True)
    z_serving = run_segment_serving(z_cfg, z_state, [(b.coords, b.feats) for b in z_chunks],
                                    z_tag, cpu_events=None)
    # 2 epochs of 2 of the serving chunks: 4 steps; another validates
    z_train, z_val = z_chunks[:2], z_chunks[2:3]
    z_training = run_segment_training(z_cfg, z_state, z_train, z_val, z_tag,
                                      reference="steps")
    counts = read_counts()
    for launches in (serving, training, z_serving, z_training, counts):
        assert not any(launches.values()), launches
    wall = time.perf_counter() - t_start
    print(f"graph phase: no hand-written kernel launched (K1-K5 counts {counts}); the phase "
          f"took {wall:.1f} s (meant to stay under {GRAPH_PHASE_TARGET_S:.0f} s"
          + ("" if wall <= GRAPH_PHASE_TARGET_S else "; it did not") + ")", flush=True)
    return state, train, val


def run_validate_cli(train, val) -> None:
    """``main --validate`` on OPs3ns_SCNet.json (the DSL's shapes checked,
    then 1 epoch over the in-memory blocks: no h5py here) and on a copy
    whose head reads 1231 features where ToDense gives 1232, which must
    raise before anything is built."""
    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    with tempfile.TemporaryDirectory() as tmp, open(CONFIG_OPS) as f:
        cfg = json.load(f)
        cfg["system_config"]["model_base_path"] = os.path.join(tmp, "model")
        good = os.path.join(tmp, "OPs3ns_SCNet.json")
        with open(good, "w") as f:
            json.dump(cfg, f)
        head = cfg["net_config"]["algorithm"].index("nn.Linear") + 1
        assert cfg["net_config"]["algorithm"][head] == [1232, 32]
        cfg["net_config"]["algorithm"][head] = [1231, 32]
        bad = os.path.join(tmp, "OPs3ns_SCNet_wrong_head.json")
        with open(bad, "w") as f:
            json.dump(cfg, f)
        try:
            cli.main([bad, "--validate", "--max_epochs", "1"])
        except IOError as e:
            message = str(e)
        else:
            raise AssertionError("main --validate accepted a head of 1231 features")
        assert "Expecting the input dimensions to be 1232, got 1231" in message, message
        chosen = cli.choose_data_module
        cli.choose_data_module = lambda config: BlockDataModule(train[:2], val)
        out = io.StringIO()
        zero_counts()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main([good, "--validate", "--max_epochs", "1"])
        finally:
            cli.choose_data_module = chosen
        launches = read_counts()
        fit = [ln for ln in out.getvalue().splitlines() if ln.startswith("fit: ")]
        assert rc == 0 and len(fit) == 1, out.getvalue()
        assert launches["subm_conv_rows"] > 0 and launches["subm_conv_rows_wgrad"] > 0
        print(f"main --validate: OPs3ns_SCNet.json passes and trains 1 epoch over in-memory "
              f"blocks (no h5py here) ({fit[0]}; launches {launches}); the "
              f"copy with a 1231-wide head is refused before anything is built: {message!r}",
              flush=True)


def run_cli(config_path, train, val, fit_keys, test_keys, kernels, hdf5_dirs=True) -> None:
    """The CLI (``waveformml_tpu_torch.main``) on the card, the config at
    ``config_path`` as shipped, 2 epochs and a test pass, with the kernels'
    counts set to 0 before and read after. Where ``hdf5_dirs`` and h5py is
    installed: over two class directories of HDF5 files that the port's
    writer writes (the HDF5 readers, the offline shuffle and
    ``PSDDataModule``), through ``main``; otherwise ``run`` over the
    in-memory blocks. Asserts the run directory ``version_0``, its
    checkpoint, the ``fit:``/``test:`` keys and a launch of each of
    ``kernels``."""
    import contextlib
    import glob
    import io

    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import (BlockDataModule,
                                                         write_classification_dirs)
    from waveformml_tpu_torch.io.hdf5 import available

    name = os.path.basename(config_path)
    with tempfile.TemporaryDirectory() as tmp, open(config_path) as f:
        cfg = json.load(f)
        cfg["system_config"]["model_base_path"] = os.path.join(tmp, "model")
        hdf5 = hdf5_dirs and available()
        t0 = time.perf_counter()
        if hdf5:
            data = os.path.join(tmp, "data")
            write_classification_dirs(data, cfg["dataset_config"]["paths"], CLI_FILES,
                                      CLI_EVENTS_PER_FILE, cfg["system_config"]["n_samples"],
                                      seed=SEED + 5)
            cfg["dataset_config"].update(base_path=data, **CLI_SPLITS)
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump(cfg, f)
        argv = [path, "-t", "--max_epochs", "2"]
        written = time.perf_counter() - t0
        out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if hdf5:
                rc = cli.main(argv)
                if rc != 0:
                    raise RuntimeError(f"the CLI exited with {rc}")
            else:
                args = cli.build_parser().parse_args(argv)
                cli.run(load_config(path), args, BlockDataModule(train, val, val))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        text = out.getvalue()
        print(text, end="", flush=True)
        if not hdf5:
            why = ("h5py is not installed, so the HDF5 readers did not run"
                   if hdf5_dirs else "the synthetic HDF5 writer writes class directories only")
            print(f"CLI phase, {name}: {why}; run() of the CLI drove a BlockDataModule of "
                  f"the in-memory training blocks instead", flush=True)
        printed = {}
        for line in text.splitlines():
            for tag in ("fit", "test"):
                if line.startswith(f"{tag}: "):
                    printed[tag] = ast.literal_eval(line[len(tag) + 2:])
        run_dir = os.path.join(tmp, "model", cfg["system_config"]["model_name"], "runs",
                               cfg["run_config"]["exp_name"], "version_0")
        ckpts = glob.glob(os.path.join(run_dir, "epoch=*-val_loss=*.ckpt"))
        assert os.path.isfile(os.path.join(run_dir, "run_info.json")) and len(ckpts) == 1
        assert set(printed["fit"]) == set(fit_keys), printed
        assert set(printed["test"]) == set(test_keys), printed
        assert all(launches[k] > 0 for k in kernels), launches
        print(f"CLI phase, {name}: HDF5 read: {'yes' if hdf5 else 'no'}; data written "
              f"in {written:.2f} s; main/run of 2 epochs and a test pass in {wall:.2f} s "
              f"(wall, host clock); {os.path.relpath(ckpts[0], tmp)}; launches {launches}; "
              f"fit {printed['fit']}; test {printed['test']}", flush=True)


# -- the profiler and the hyperparameter study ------------------------------------------

def global_kernel_names() -> dict:
    """Each kernel's ``__global__`` function names, read from its CUDA
    source: the names ``kernel_name`` gives its grids, without template
    arguments."""
    import re

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    names = {}
    for kernel, source in (("subm_conv_rows", "row_conv.cu"),
                           ("site_grouped_matmul", "site_head.cu"),
                           ("subm_conv_rows_wgrad", "row_conv_wgrad.cu"),
                           ("site_grouped_matmul_bwd", "site_head_bwd.cu")):
        with open(os.path.join(ROOT, "waveformml_tpu_torch", "csrc", source)) as f:
            names[kernel] = set(pattern.findall(f.read()))
        assert names[kernel], (kernel, source)
    return names


def median_step_wall_ms(*trainers) -> float:
    """The median wall of the fits' steps but each fit's first, in ms."""
    return statistics.median(p["wall_s"] for t in trainers for p in t.step_phases[1:]) * 1e3


def run_profiler(cfg, state, train, val) -> None:
    """``Trainer.fit`` with ``profiler=True`` and no TensorBoard logger (as
    where tensorboardX is not installed), 2 epochs × 4 steps: the table
    (``profile_results.txt``) and the trace (``profile/*.pt.trace.json``)
    in the checkpoint directory; the table's calls of each section, the
    trace's grids of K1, K2, K4 and K5 by name, the losses against a
    profiler-off fit from the same state, and the median step wall with the
    profiler on and off (fits off, on, on, off; steps 1-7 of each)."""
    import glob

    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    data = BlockDataModule(train, val)
    with tempfile.TemporaryDirectory() as run_dir:
        plain_fit = make_trainer(cfg, state, plain=False)
        counted_fit(plain_fit, data, "profiler off")
        profiled = make_trainer(cfg, state, plain=False, checkpoint_dir=run_dir, profiler=True)
        t0 = time.perf_counter()
        counted_fit(profiled, data, "profiler on")
        wall = time.perf_counter() - t0
        # the same again in the other order, so that neither side takes the
        # process's warm-up alone
        with tempfile.TemporaryDirectory() as again_dir:
            profiled_again = make_trainer(cfg, state, plain=False, checkpoint_dir=again_dir,
                                          profiler=True)
            profiled_again.fit(data)
        plain_again = make_trainer(cfg, state, plain=False)
        plain_again.fit(data)
        with open(os.path.join(run_dir, "profile_results.txt")) as f:
            table = f.read()
        calls = {}
        for line in table.splitlines()[6:]:
            cells = [c.strip() for c in line.split("|")]
            calls[cells[0]] = int(cells[2])
        steps = TRAIN_EPOCHS * TRAIN_CHUNKS
        want = {"run_training_step": steps, "get_train_batch": steps,
                "evaluation_step": TRAIN_EPOCHS * VAL_CHUNKS}
        assert calls == want, (calls, want)
        traces = glob.glob(os.path.join(run_dir, "profile", "*.pt.trace.json"))
        assert len(traces) == 1, os.listdir(run_dir)
        trace_bytes = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    grids = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = kernel_name(e.get("name", ""))
            grids[name] = grids.get(name, 0) + 1
    found = {}
    for kernel, names in global_kernel_names().items():
        found[kernel] = {g: n for g, n in grids.items() if g.split("<")[0] in names}
        assert found[kernel], (kernel, sorted(grids)[:40])
    for other in (profiled, profiled_again, plain_again):
        np.testing.assert_allclose(other.step_losses, plain_fit.step_losses, rtol=1e-5)
    on = median_step_wall_ms(profiled, profiled_again)
    off = median_step_wall_ms(plain_fit, plain_again)
    print(f"profiler: profile_results.txt {calls} (as the JAX Trainer writes for this loop); "
          f"trace {os.path.basename(traces[0])} {trace_bytes} bytes, {len(events)} events, "
          f"{sum(grids.values())} kernel records; the kernels' grids in it: "
          f"{ {k: sorted(v.items()) for k, v in found.items()} }; losses equal the "
          f"profiler-off fit's (rtol 1e-5); fit with the profiler {wall:.3f} s (wall, host "
          f"clock, trace export included)", flush=True)
    print(f"profiler cost: median step wall {on:.3f} ms with the profiler (each step "
          f"synchronised), {off:.3f} ms without (steps 1-7 of fits off, on, on, off): "
          f"{on - off:+.3f} ms a step ({(on - off) / off:+.1%})", flush=True)
    print("profiler table:\n" + table, end="", flush=True)


def replayed_params(mo, recorded, sampler, pruner) -> list:
    """The params that ``sampler`` and ``pruner`` suggest in a fresh
    in-memory study whose objective replays each recorded trial's
    intermediate values, state and value (the study's own
    ``modify_config``)."""
    from waveformml_tpu_torch.optimization.hpo import TrialPruned, create_study

    replay = create_study(sampler=sampler, pruner=pruner)
    history = iter(recorded)

    def objective(trial):
        rec = next(history)
        mo.modify_config(trial)
        trial.intermediate_values.update(rec.intermediate_values)
        if rec.state == "PRUNED":
            raise TrialPruned()
        return rec.value

    replay.optimize(objective, n_trials=len(recorded))
    return [t.params for t in replay.get_trials()]


def run_hpo(model, train, val) -> None:
    """``ModelOptimization`` over SubMPSD.json as shipped (HPO_STUDY: TPE
    over lr and momentum, the median pruner), 4 trials of up to HPO_EPOCHS
    epochs of 4 steps over in-memory blocks (h5py not needed),
    with pruning. Each trial's kernel counts set to 0 before it and read
    after (its launches asserted against its epochs' steps and
    validations), its wall, its peak device memory and the device memory
    left after it (back within HPO_MEMORY_SLACK of the study's start). The
    study.db's 4 trials COMPLETE or PRUNED, trial_results.json written; the
    same samplers replayed on the recorded values suggest the recorded
    params; the best trial's checkpoint served against the plain versions
    on the card; ``eval_best_trials`` over the top 2 trials, run in process
    through ``evaluate.run`` over the validation chunk."""
    from waveformml_tpu_torch import evaluate
    from waveformml_tpu_torch.config import Config, load_config
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.inference.model import InferenceModel
    from waveformml_tpu_torch.io.hdf5 import available
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.optimization.hpo import (PRUNERS, SAMPLERS, ModelOptimization,
                                                       OptunaDB, create_study)
    from waveformml_tpu_torch.scripts import eval_best_trials
    from waveformml_tpu_torch.utils.util import get_model_folder, retrieve_best_checkpoint

    print(f"HPO phase: the trials train on in-memory blocks (BlockDataModule) "
          f"{'although' if available() else 'because'} h5py is "
          f"{'installed' if available() else 'not installed'} here; the study writes its "
          f"sqlite study.db, trial configs and checkpoints to disk", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with open(CONFIG) as f:
            raw = json.load(f)
        raw["system_config"]["model_base_path"] = os.path.join(tmp, "model")
        cfg_path = os.path.join(tmp, "SubMPSD.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        cfg = load_config(cfg_path)
        study_config = Config(copy.deepcopy(HPO_STUDY))
        mo = ModelOptimization(study_config, cfg, get_model_folder(cfg),
                               trainer_args={"max_epochs": HPO_EPOCHS},
                               data_module=BlockDataModule(train, val))
        records = {}
        objective = mo.objective

        def measured(trial):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            try:
                return objective(trial)
            finally:
                torch.cuda.synchronize()
                records[trial.number] = {
                    "wall_s": time.perf_counter() - t0, "launches": read_counts(),
                    "peak": torch.cuda.max_memory_allocated(),
                    "after": torch.cuda.memory_allocated()}

        mo.objective = measured
        torch.manual_seed(SEED + 90)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        study = mo.run_study(pruning=True)
        study_wall = time.perf_counter() - t0
        db_path = os.path.join(mo.study_dir, "study.db")
        recorded = create_study(study_name=mo.study_name,
                                storage="sqlite:///" + db_path).get_trials()
        assert len(recorded) == HPO_STUDY["optimize_args"]["n_trials"], len(recorded)
        assert all(t.state in ("COMPLETE", "PRUNED") for t in recorded), \
            [t.state for t in recorded]
        assert any(t.state == "COMPLETE" for t in recorded)
        with open(os.path.join(mo.study_dir, "trial_results.json")) as f:
            results = json.load(f)
        assert results["n_finished_trials"] == len(recorded), results
        for t in recorded:
            r = records[t.number]
            epochs = len(t.intermediate_values)
            want = training_launches(model, epochs * len(train), epochs * len(val))
            assert r["launches"] == want, (t.number, r["launches"], want)
            assert all(r["launches"][k] > 0 for k in ("subm_conv_rows", "site_grouped_matmul",
                                                      "subm_conv_rows_wgrad",
                                                      "site_grouped_matmul_bwd"))
            assert abs(r["after"] - before) <= HPO_MEMORY_SLACK, (t.number, r["after"], before)
            print(f"HPO trial {t.number}: params {t.params}; {t.state}; {epochs} epochs; best "
                  f"val_loss {min(t.intermediate_values.values()):.6f}; wall "
                  f"{r['wall_s']:.3f} s; peak device memory {r['peak'] / 2**20:.1f} MiB; "
                  f"allocated after it {r['after'] / 2**20:.1f} MiB (before the study "
                  f"{before / 2**20:.1f} MiB); launches {r['launches']}", flush=True)

        sampler = SAMPLERS[HPO_STUDY["sampler"]](**HPO_STUDY["sampler_params"])
        pruner = PRUNERS[HPO_STUDY["pruner"]](**HPO_STUDY["pruner_params"])
        replayed = replayed_params(mo, recorded, sampler, pruner)
        assert replayed == [t.params for t in recorded], (replayed, recorded)

        # the best trial's checkpoint served, against the plain versions
        reader = OptunaDB(db_path)
        best = reader.get_best_trial()
        top = reader.get_top_trials(2)
        reader.close()
        trial_dir = os.path.join(mo.study_dir, f"trial_{best}")
        ckpt = retrieve_best_checkpoint(trial_dir)
        trial_cfg = load_config(os.path.join(trial_dir, "config.json"))
        served = InferenceModel(trial_cfg, ckpt)
        reference = InferenceModel(trial_cfg, ckpt)
        for module in reference.task.model.modules():
            if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
                module.plain = True
        got = served(val[0].coords, val[0].feats)
        want_logits = reference(val[0].coords, val[0].feats)
        assert got.shape == (val[0].labels.shape[0], cfg.system_config.n_type)
        np.testing.assert_allclose(got, want_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)

        # eval_best_trials over the top 2, each evaluate command run in process
        evaluated = []

        def in_process(argl):
            args = evaluate.build_parser().parse_args(argl[3:])
            config = load_config(args.config)
            evaluate.apply_overrides(config, args)
            out = io.StringIO()
            zero_counts()
            with contextlib.redirect_stdout(out):
                res = evaluate.run(config, args, BlockDataModule([], [], val))
            evaluated.append((argl[3], res["test"], read_counts()))
            return 0

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            eval_best_trials.main([cfg_path, "-n", "2"], call=in_process)
        assert [os.path.basename(os.path.dirname(p)) for p, _, _ in evaluated] == \
            [f"trial_{n}" for n, _ in top], (evaluated, top)
        for _, metrics, launches in evaluated:
            assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
            assert launches["subm_conv_rows"] > 0 and launches["site_grouped_matmul"] > 0
    print(f"HPO study: {len(recorded)} trials ({[t.state for t in recorded]}) in "
          f"{study_wall:.3f} s (wall, host clock); best trial {best} "
          f"(value {results.get('best_trial')}); its checkpoint serves the validation chunk "
          f"as the plain versions on the card (rtol={LOGIT_RTOL}, atol={LOGIT_ATOL}, largest "
          f"|difference| {float(np.abs(got - want_logits).max()):.3g}); the samplers replayed "
          f"on the recorded values suggest the recorded params; eval_best_trials evaluated "
          f"{[(os.path.basename(os.path.dirname(p)), m) for p, m, _ in evaluated]} through "
          f"evaluate.run", flush=True)


# -- data-parallel training --------------------------------------------------------------

#: two ranks against one process on the whole blocks, from the same weights:
#: each tensor's change over the steps (final − init, ``delta_reading``)
#: within DP_DELTA_LIMIT of one process's, relative to the change, and each
#: step's loss within DP_LOSS_RTOL. Both limits lie between two readings of
#: this phase on an NVIDIA H100 80GB HBM3 at 700 W: one process with each
#: event's rows reordered (float32 rounding alone: changes 1.08e-05 to
#: 1.24e-05 apart, losses equal) and the ranks (1.51e-05, 1.53e-05, losses
#: equal), against faults planted in a copy: the BatchNorm all-reduce's
#: backward the identity (24.5; losses 4.29e-06 apart) and the gradients
#: averaged over the ranks, not summed (0.527; losses 2.42e-02 apart)
DP_DELTA_LIMIT, DP_LOSS_RTOL = 1e-3, 1e-6
#: a group of one against no group (phase 8c a): rtol 1e-5, atol 1e-6 (K1's
#: atomics vary the last bits from run to run)
DP_NCCL_RTOL, DP_NCCL_ATOL = 1e-5, 1e-6
DP_STEPS = 4
DP_TIMEOUT_S = 300
#: the ranks of phase 8c (b), all on the one card
DP_DEVICES = ("cuda:0", "cuda:0")

DP_RANK_SCRIPT = r"""
import json
import pickle
import sys
import time

import torch
import torch.distributed as dist

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.ops.row_conv import subm_conv_rows, subm_conv_rows_wgrad
from waveformml_tpu_torch.ops.site_head import site_grouped_matmul, site_grouped_matmul_bwd
from waveformml_tpu_torch.parallel.mesh import initialize_distributed
from waveformml_tpu_torch.registry import retrieve_class

job_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(job_path, "rb") as f:
    job = pickle.load(f)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device(job["devices"][rank])
sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
initialize_distributed(job["init_method"], world, rank, backend=job["backend"], device=device)
# every all-reduce and all-gather timed on the host clock, the card
# synchronised before and after it; those of the training epoch (bucket
# agreement, BatchNorm sums forward and backward, the weight, the gradients,
# under tp the column blocks' gathers and d_feats' sums) summed by step, and
# by the group they ran over
spent = {"train_s_by_step": [], "train_calls": 0, "all_s": 0.0, "all_calls": 0,
         "train_s_by_group": {}}
in_train = [False]
groups = {}


def timed(collective):
    def call(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = collective(*args, **kwargs)
        sync()
        dt = time.perf_counter() - t0
        spent["all_s"] += dt
        spent["all_calls"] += 1
        if in_train[0]:
            spent["train_s_by_step"][-1] += dt
            spent["train_calls"] += 1
            label = groups.get(id(kwargs.get("group")), "world")
            spent["train_s_by_group"][label] = spent["train_s_by_group"].get(label, 0.0) + dt
        return out
    return call


dist.all_reduce = timed(dist.all_reduce)
dist.all_gather_into_tensor = timed(dist.all_gather_into_tensor)
cfg = Config(job["config"])
task = retrieve_class(cfg.run_config.run_class)(cfg, device)
task.model.load_state_dict(job["state"])
trainer = Trainer(cfg, task, device=device, max_epochs=1, tp=job.get("tp", 1))
if trainer.mesh is not None:
    groups = {id(trainer.mesh.data_group): "data", id(trainer.mesh.model_group): "model"}
train_epoch = trainer._train_epoch


def counted_train_epoch(loader):
    in_train[0] = True
    try:
        return train_epoch(loader)
    finally:
        in_train[0] = False


trainer._train_epoch = counted_train_epoch
loop_batch = trainer._loop_batch


def step_loop_batch(block):
    # a training step starts with its batch (the buckets' agreement)
    if in_train[0]:
        spent["train_s_by_step"].append(0.0)
    return loop_batch(block)


trainer._loop_batch = step_loop_batch
kernels = (subm_conv_rows, site_grouped_matmul, subm_conv_rows_wgrad, site_grouped_matmul_bwd)
sync()
for fn in kernels:
    fn.launches = 0
t0 = time.perf_counter()
metrics = trainer.fit(BlockDataModule(job["train"], job["val"]))
sync()
wall = time.perf_counter() - t0
launches = {fn.__name__: fn.launches for fn in kernels}
state = {k: v.cpu() for k, v in trainer.model_state_dict().items()}
torch.save(state, f"{job_path}.rank{rank}.pt")
blocks = ({k: list(task.model.state_dict()[k].shape) for k in trainer.tensor_parallel.specs}
          if trainer.tensor_parallel is not None else {})
dist.destroy_process_group()
print(json.dumps({"rank": trainer.rank, "world_size": trainer.world_size,
                  "mesh": trainer.mesh.shape if trainer.mesh is not None else None,
                  "blocks": blocks,
                  "launches": launches, "step_losses": trainer.step_losses,
                  "metrics": metrics, "fit_wall_s": wall,
                  "step_wall_s": [p["wall_s"] for p in trainer.step_phases],
                  "events": [p["events"] for p in trainer.step_phases],
                  **spent}), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def delta_reading(got, want, init) -> float:
    """How far ``got`` moved from ``init`` otherwise than ``want`` did: the
    largest over the float tensors of ||got − want||₂ over the change
    ||want − init||₂, the change floored at the median tensor's change per
    element (a conv bias ahead of a BatchNorm has a zero gradient, so its
    change is float32 rounding alone and is held to that floor)."""
    keys = [k for k, w in want.items() if w.is_floating_point()]
    moved = {k: float((want[k].double() - init[k].double()).norm()) / want[k].numel() ** 0.5
             for k in keys}
    floor = float(np.median(list(moved.values())))
    return max(float((got[k].double() - want[k].double()).norm())
               / (want[k].numel() ** 0.5 * max(moved[k], floor)) for k in keys)


def loss_reading(got, want) -> float:
    """The largest |got − want| / |want| over the steps."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.abs(want)).max())


def states_close(got, want, rtol: float, atol: float, label: str) -> float:
    """Assert every element of each tensor of ``got`` within ``atol + rtol
    · |want|``; returns the largest |difference| over that bound (≤ 1)."""
    worst = 0.0
    for k, w in want.items():
        w = w.float().cpu()
        ratio = float(((got[k].float().cpu() - w).abs() / (atol + rtol * w.abs())).max())
        assert ratio <= 1.0, (label, k, ratio)
        worst = max(worst, ratio)
    return worst


def reorder_rows(block, seed: int):
    """``block`` with the rows of each event in another order (the events
    and their order kept)."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock

    key = np.random.default_rng(seed).permutation(block.coords.shape[0])
    order = np.lexsort((key, block.coords[:, -1]))
    return FileBlock(block.coords[order], block.feats[order], block.labels, {})


def run_dp_nccl(cfg, train, val) -> None:
    """Phase 8c (a): SubMPSD.json through the CLI's ``run`` with
    ``--distributed --num_processes 1`` (one NCCL rank on the card: every
    all-reduce of the data-parallel step runs, on one rank) against the
    same ``run`` without ``--distributed``, from the same seeded init, 2
    epochs × 4 steps over in-memory blocks: the fit metrics within
    DP_NCCL_RTOL, the best checkpoints' weights within rtol DP_NCCL_RTOL, atol
    DP_NCCL_ATOL; K1, K2, K4 and K5 launched in the group's run."""
    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    with tempfile.TemporaryDirectory() as tmp:
        with open(CONFIG) as f:
            d = json.load(f)
        d["system_config"]["model_base_path"] = os.path.join(tmp, "model")
        path = os.path.join(tmp, "SubMPSD.json")
        with open(path, "w") as f:
            json.dump(d, f)
        out = {}
        for mode in ("one device", "NCCL group of one"):
            argv = [path, "--max_epochs", "2"]
            if mode != "one device":
                argv += ["--distributed", "--coordinator", f"localhost:{free_port()}",
                         "--num_processes", "1", "--process_id", "0"]
            args = cli.build_parser().parse_args(argv)
            torch.manual_seed(SEED + 81)        # the same init in both runs
            zero_counts()
            t0 = time.perf_counter()
            res = cli.run(load_config(path), args, BlockDataModule(train, val, val))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            assert all(launches[k] > 0 for k in ("subm_conv_rows", "site_grouped_matmul",
                                                 "subm_conv_rows_wgrad",
                                                 "site_grouped_matmul_bwd")), launches
            ckpts = [p for p in os.listdir(res["log_dir"]) if p.endswith(".ckpt")]
            assert len(ckpts) == 1, ckpts
            state = torch.load(os.path.join(res["log_dir"], ckpts[0]), map_location="cpu",
                               weights_only=True)["state_dict"]
            out[mode] = (res["fit"], state, launches, wall)
            print(f"phase 8c (a), {mode}: run() of 2 epochs in {wall:.3f} s (wall, host "
                  f"clock); launches {launches}; fit {res['fit']}", flush=True)
        import torch.distributed as dist

        assert not dist.is_initialized(), "run() left its process group"
        (fit0, st0, n0, _), (fit1, st1, n1, _) = out.values()
        assert n0 == n1, (n0, n1)
        for k, v in fit0.items():
            assert abs(fit1[k] - v) <= DP_NCCL_RTOL * abs(v) + 1e-6, (k, fit1[k], v)
        worst = states_close(st1, st0, DP_NCCL_RTOL, DP_NCCL_ATOL, "8c (a)")
        print(f"phase 8c (a): the NCCL group of one matches one device: fit metrics within "
              f"rtol {DP_NCCL_RTOL}, the best checkpoint's weights at {worst:.3g} of the "
              f"bound (rtol {DP_NCCL_RTOL}, atol {DP_NCCL_ATOL}); the same launches",
              flush=True)


def dp_reference(cfg, state, train, val) -> dict:
    """The one-process run that the ranks of phases 8c (b) and 8d are held
    to: ``make_trainer`` (the kernels) fitting DP_STEPS 4096-event blocks
    and the validation block from ``state``, its launches asserted; and the
    same with each event's rows reordered, whose readings against it are
    float32 rounding alone."""
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    blocks, vblock = train[:DP_STEPS], val[:1]
    zero_counts()
    one = make_trainer(cfg, state, plain=False, max_epochs=1)
    one_metrics = one.fit(BlockDataModule(blocks, vblock))
    torch.cuda.synchronize()
    want = training_launches(one.task.model, DP_STEPS, 1)
    assert read_counts() == want, (read_counts(), want)
    one_state = {k: v.detach().cpu() for k, v in one.task.model.state_dict().items()}
    # the same process again with each event's rows reordered: how far
    # float32 rounding alone moves the weights
    reordered = make_trainer(cfg, state, plain=False, max_epochs=1)
    reordered.fit(BlockDataModule([reorder_rows(b, SEED + 82) for b in blocks], vblock))
    init = {k: v.detach().cpu() for k, v in state.items()}
    return {"blocks": blocks, "vblock": vblock, "metrics": one_metrics, "want": want,
            "state": one_state, "init": init, "losses": one.step_losses,
            "step_ms": [round(p["wall_s"] * 1e3, 3) for p in one.step_phases],
            "rounding": delta_reading({k: v.detach().cpu() for k, v in
                                       reordered.task.model.state_dict().items()},
                                      one_state, init),
            "rounding_loss": loss_reading(reordered.step_losses, one.step_losses)}


def run_dp_ranks(cfg, state, train, val, devices, backend: str, tag: str, ref=None,
                 tp: int = 1, root: str = ROOT, check: bool = True) -> dict:
    """Data-parallel ranks, one a device of ``devices`` (phase 8c (b): two
    ranks sharing the card over Gloo, which stages CUDA tensors through the
    host; ``--dp-ranks N``: N cards over NCCL), each started as a process
    of its own (``DP_RANK_SCRIPT``, importing the port from ``root``), each
    on its share of the events of each of DP_STEPS 4096-event blocks
    (``split_block_for_devices``; the Trainer reads the shards round-robin)
    and of the validation block, against ``dp_reference`` (``ref``, made
    here where not given) on the whole blocks, from the same weights: every
    step's loss and the final weights and running statistics within the DP
    tolerances, the ranks' losses equal; each rank's K1, K2, K4 and K5
    launches equal to ``training_launches`` of its steps and validation;
    prints each rank's launches, its step wall and the collectives' share
    of it. With ``tp > 1`` the ranks form a (len / tp, tp) grid (phase 8d):
    the blocks are split over the data ranks only, and each rank prints
    its blocks' shapes and the collectives' time by group. ``check=False``
    asserts nothing of the readings (a planted fault's run). Returns the
    readings: ``delta`` (the worst rank's) and ``loss``."""
    from waveformml_tpu_torch.config import to_dict
    from waveformml_tpu_torch.parallel.mesh import split_block_for_devices

    ref = ref or dp_reference(cfg, state, train, val)
    blocks, vblock, init, one_state = ref["blocks"], ref["vblock"], ref["init"], ref["state"]
    n = len(devices)
    dp = n // tp
    shards = [split_block_for_devices(b, dp) for b in blocks]
    assert all(h.labels.shape[0] == EVENTS_PER_CHUNK // dp for hs in shards for h in hs)
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job")
        with open(job, "wb") as f:
            pickle.dump({"init_method": f"file://{tmp}/rendezvous", "devices": list(devices),
                         "backend": backend, "config": to_dict(cfg), "tp": tp,
                         "state": {k: v.detach().cpu() for k, v in state.items()},
                         "train": [h for hs in shards for h in hs],
                         "val": split_block_for_devices(vblock[0], dp)}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", DP_RANK_SCRIPT, job, str(r), str(n)],
                                  cwd=root, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for p, (so, se) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"a data-parallel rank exited {p.returncode}:\n{se[-6000:]}")
        ranks = [json.loads([ln for ln in so.splitlines() if ln.startswith("{")][-1])
                 for so, _ in outs]
        states = [torch.load(f"{job}.rank{r}.pt", weights_only=True) for r in range(n)]
    grid = f" on a ({dp}, {tp}) grid" if tp > 1 else ""
    print(f"phase {tag}: {n} ranks{grid} over {backend} on {sorted(set(devices))}, {DP_STEPS} "
          f"steps of {EVENTS_PER_CHUNK // dp} events a rank, in {wall:.2f} s (wall, host clock, "
          f"the processes' start and the kernels' loading included)", flush=True)
    deltas = [delta_reading(st, one_state, init) for st in states]
    loss_err = loss_reading(ranks[0]["step_losses"], ref["losses"])
    # the readings first, so that a run that fails shows them
    print(f"phase {tag}: against one process on the whole blocks (metrics {ref['metrics']}): "
          f"the change of the weights and running statistics over {DP_STEPS} steps at "
          f"{max(deltas):.3g} of one process's (worst tensor, L2; limit {DP_DELTA_LIMIT}), the "
          f"losses at {loss_err:.3g} (relative; limit {DP_LOSS_RTOL}); one process with each "
          f"event's rows reordered: {ref['rounding']:.3g} and {ref['rounding_loss']:.3g}; one "
          f"process's steps {ref['step_ms']} ms", flush=True)
    for r, info in enumerate(ranks):
        steps, reduced = info["step_wall_s"], info["train_s_by_step"]
        assert len(reduced) == len(steps), (reduced, steps)
        median_ms = statistics.median(steps[1:]) * 1e3
        by_group = "; ".join(f"{g} {t * 1e3:.3f} ms ({t / sum(steps):.1%})"
                             for g, t in sorted(info["train_s_by_group"].items()))
        # the first step holds the group's first exchanges: its own line
        print(f"phase {tag} rank {r} ({devices[r]}, mesh {info['mesh']}): launches "
              f"{info['launches']}; blocks {info['blocks']}; change at {deltas[r]:.3g} of one "
              f"process's; step walls {[round(t * 1e3, 3) for t in steps]} ms (median of steps "
              f"1-{len(steps) - 1} {median_ms:.3f} ms); collectives a step "
              f"{[round(t * 1e3, 3) for t in reduced]} ms ({info['train_calls']} calls in the "
              f"training epoch, each timed between two synchronisations of the card), "
              f"{sum(reduced[1:]) / sum(steps[1:]):.1%} of steps 1-{len(steps) - 1}'s wall; by "
              f"group over the epoch's steps: {by_group}; fit {info['fit_wall_s']:.3f} s with "
              f"{info['all_calls']} collectives taking {info['all_s'] * 1e3:.3f} ms; "
              f"metrics {info['metrics']}", flush=True)
    readings = {"delta": max(deltas), "loss": loss_err, "ranks": ranks}
    if not check:
        return readings
    assert all(r["step_losses"] == ranks[0]["step_losses"] for r in ranks), ranks
    assert loss_err <= DP_LOSS_RTOL, (loss_err, ranks[0]["step_losses"], ref["losses"])
    want = ref["want"]
    for r, info in enumerate(ranks):
        assert info["rank"] == r and info["world_size"] == n, info
        assert info["launches"] == {k: v for k, v in want.items() if k in info["launches"]}, (
            info["launches"], want)
        assert all(v > 0 for v in info["launches"].values()), info["launches"]
        assert deltas[r] <= DP_DELTA_LIMIT, (tag, r, deltas[r])
    print(f"phase {tag}: the ranks' losses equal, and match one process's", flush=True)
    return readings


# -- tensor-parallel training ----------------------------------------------------------

#: phase 8d: the model degree, and the planted fault: copy_to_model's
#: backward without its sum over the model group (the identity)
TP = 2
TP_FAULT = "        dist.all_reduce(total, group=ctx.mesh.model_group)\n"


def tp_view(model, tp: int = TP, m: int = 0):
    """The column blocks that rank ``m`` of a model group holds of
    SubMPSD's sharded layers (``parallel.gspmd``'s rule: at SubMPSD.json's
    widths the two k=3 convs and the head), as layers the kernel checks
    take: the convs' ``stack`` and the head's ``head0``, each without its
    bias, which the tensor-parallel layers add after the gather."""
    from types import SimpleNamespace

    from torch import nn

    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.parallel.gspmd import block_of, tp_specs

    specs = tp_specs(model, tp)
    convs = []
    for name, conv in model.stack.named_children():
        spec = specs.get(f"stack.{name}.weight")
        if isinstance(conv, RowSubMConv2d) and spec is not None:
            block = copy.deepcopy(conv)
            block.weight = nn.Parameter(block_of(conv.weight.detach(), spec, tp, m))
            block.bias = None
            convs.append(block)
    head = copy.deepcopy(model.head0)
    head.weight = nn.Parameter(block_of(model.head0.weight.detach(), specs["head0.weight"],
                                        tp, m))
    head.features, head.bias = head.weight.shape[1], None
    return SimpleNamespace(stack=nn.ModuleList(convs), head0=head)


def run_tp(cfg, state, train, val, ref, model, db) -> tuple:
    """Phase 8d: SubMPSD.json trained tensor-parallel (``Trainer(tp=2)``)
    by ranks sharing the card over Gloo, on (a) a (1, 2) and (b) a (2, 2)
    grid, each held to ``dp_reference`` by ``run_dp_ranks``; then the same
    (1, 2) run from a copy of the port in which ``copy_to_model``'s backward
    is the identity, whose readings must break a limit; then K1 (forward
    and as d_feats), K4, K2 and K5 at the column blocks' widths
    (``tp_view``) against their plain versions on ``db``. Returns the
    kernel results by name and the launches of (b)'s rank 0."""
    import shutil

    for dp, tag in ((1, "8d (a)"), (2, "8d (b)")):
        ranks = run_dp_ranks(cfg, state, train, val, ["cuda:0"] * (dp * TP), "gloo", tag,
                             ref=ref, tp=TP)["ranks"]
    launches = ranks[0]["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ROOT, "waveformml_tpu_torch"),
                        os.path.join(tmp, "waveformml_tpu_torch"))
        # the kernels this run built, so that the copy builds none
        shutil.copytree(os.path.join(ROOT, "build"), os.path.join(tmp, "build"))
        path = os.path.join(tmp, "waveformml_tpu_torch", "parallel", "gspmd.py")
        with open(path) as f:
            source = f.read()
        assert source.count(TP_FAULT) == 1
        with open(path, "w") as f:
            f.write(source.replace(TP_FAULT, ""))
        fault = run_dp_ranks(cfg, state, train, val, ["cuda:0"] * TP, "gloo",
                             "8d (planted fault)", ref=ref, tp=TP, root=tmp, check=False)
    print(f"phase 8d (planted fault: copy_to_model's backward the identity): the change at "
          f"{fault['delta']:.3g} (limit {DP_DELTA_LIMIT}), the losses at {fault['loss']:.3g} "
          f"(limit {DP_LOSS_RTOL}): the check fails it", flush=True)
    assert fault["delta"] > DP_DELTA_LIMIT or fault["loss"] > DP_LOSS_RTOL, fault
    view = tp_view(model)
    print(f"phase 8d kernels at the column blocks of model rank 0: convs "
          f"{[tuple(c.weight.shape) for c in view.stack]}, head "
          f"{tuple(view.head0.weight.shape)} (C={view.head0.cin}, F={view.head0.features}), "
          f"no bias", flush=True)
    results = {"subm_conv_rows": check_subm_conv_rows(view, db, db["feats"], tag="tp "),
               "site_grouped_matmul": check_site_grouped_matmul(view, db, tag="tp ")}
    results["subm_conv_rows_wgrad"], d_feats_err = check_subm_conv_rows_wgrad(
        view, db, db["feats"], tag="tp ")
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_feats_err)
    results["site_grouped_matmul_bwd"] = check_site_grouped_matmul_bwd(view, db, tag="tp ")
    return results, launches


# -- the prediction writers ------------------------------------------------------------

def writer_configs(tmp: str) -> dict:
    """The writers' configs, each from a shipped one with only what the
    records force changed, written into ``tmp``: name → path. Z:
    SingleEndedZCNN.json at 65 samples (the records' 130 int16 samples a
    row), and a copy whose dataset class reads WaveformPairNorm; IRN:
    SubMPSD.json with ``n_type`` 3 (the three columns ``phys[:, 4:7]``);
    IRNIM: SegQuantifier.json's net as ``LitSegClassifier`` with
    ``CrossEntropyLoss`` and ``n_type`` 5 (the five class scores), its
    dataset class reading WaveformPairNorm."""
    with open(CONFIG_Z) as f:
        z = json.load(f)
    z["system_config"]["n_samples"] = 65
    z_norm = copy.deepcopy(z)
    z_norm["dataset_config"]["dataset_class"] = "PulseDatasetWFPairNorm"
    with open(CONFIG) as f:
        irn = json.load(f)
    irn["system_config"].update(n_type=3, type_names=["phys4", "phys5", "phys6"])
    with open(CONFIG_SEGQ) as f:
        irnim = json.load(f)
    irnim["run_config"]["run_class"] = "LitSegClassifier"
    irnim["net_config"]["criterion_class"] = "CrossEntropyLoss"
    irnim["system_config"].update(n_type=5, type_names=["ioni", "recoil", "ncap", "ingress",
                                                        "muon"])
    irnim["dataset_config"]["dataset_class"] = "PulseDatasetWFPairNorm"
    paths = {}
    for name, cfg in (("z", z), ("z_norm", z_norm), ("irn", irn), ("irnim", irnim)):
        paths[name] = os.path.join(tmp, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


def stream_prefix(records, record_type, read: int, reads: int, tail_rows: int):
    """The records of ``reads`` read chunks of ``read`` rows, as the
    writers' reader cuts them at event boundaries, the last one a short
    chunk of about ``tail_rows`` rows (whole events)."""
    from waveformml_tpu_torch.datasets.synthetic import MemoryInput

    inp = MemoryInput("prefix", {record_type.name: records})
    inp.setup_table(record_type.name, record_type.type, record_type.event_index_name,
                    event_index_coord=record_type.event_index_coord)
    rows = 0
    for i, chunk in enumerate(inp.iter_chunks(read, preserve_event="truncate")):
        if i == reads - 1:
            break
        rows += chunk.shape[0]
    ev = inp._event_numbers(records)
    end = rows + tail_rows
    while end < len(records) and ev[end] == ev[end - 1]:
        end += 1
    assert end < len(records), (end, len(records))
    return records[:end]


class PipelineWatch:
    """Wraps an ``InferenceModel``'s ``dispatch``, ``fetch`` and
    ``_capture`` to count dispatched and fetched chunks (the fetches run
    on the writer's worker threads) and, at each capture of a new layout,
    the chunks then in flight."""

    def __init__(self, model):
        import threading

        self.lock = threading.Lock()
        self.dispatched = self.fetched = 0
        self.in_flight_at_capture = []
        dispatch, fetch, capture = model.dispatch, model.fetch, model._capture

        def counted_dispatch(*args):
            handle = dispatch(*args)
            with self.lock:
                self.dispatched += 1
            return handle

        def counted_fetch(handle):
            out = fetch(handle)
            with self.lock:
                self.fetched += 1
            return out

        def counted_capture(*args):
            with self.lock:
                self.in_flight_at_capture.append(self.dispatched - self.fetched)
            return capture(*args)

        model.dispatch, model.fetch, model._capture = counted_dispatch, counted_fetch, \
            counted_capture


def reference64(cfg_path: str, ckpt: str, coords, feats, read: int = 2048) -> np.ndarray:
    """A model's outputs over a stream of rows on the CPU with its
    parameters and features in float64 (rounded to float32 at the end, as
    ``apply_model`` returns them), in chunks of whole events: ``[N, C]``
    a row for per-row models, the Z map's value at each row (``[N]``) for
    the Z models. Every output depends on its own event's rows only."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.ops.sparse import consecutive_event_index
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = load_config(cfg_path)
    task = retrieve_class(cfg.run_config.run_class)(cfg, "cpu")
    task.model.load_state_dict(torch.load(ckpt, weights_only=True))
    task.model.double().eval()
    ev = consecutive_event_index(coords[:, -1])
    out, lo = [], 0
    while lo < len(ev):
        hi = min(lo + read, len(ev))
        while hi < len(ev) and ev[hi] == ev[hi - 1]:
            hi += 1
        c = coords[lo:hi].astype(np.int32)
        c[:, -1] = ev[lo:hi] - ev[lo]
        block = FileBlock(c, np.asarray(feats[lo:hi], np.float64),
                          np.zeros(hi - lo, np.float32))
        db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                               task.event_bucket(block)))
        db = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
              for k, v in db.items()}
        with torch.no_grad():
            o = task.apply_model(db).numpy()
        out.append(o[c[:, -1], 0, c[:, 0], c[:, 1]] if o.ndim == 4 else o[:hi - lo])
        lo = hi
    return np.concatenate(out)


def compare_writer_rows(got, want, inp, kind: str, scores=None, z=None):
    """A writer's rows on the card (``got``) against its CPU run
    (``want``): the same rows in the same order, every field the writer
    copies equal, the random fields of PhysPulse records in [0, 1) on the
    rows that draw them and equal elsewhere. The model's outputs in the
    fields it writes (a z as the model's own output, z /
    Z_NORMALIZATION_FACTOR + 0.5; a row's scores together): where its
    float64 outputs are given (``scores`` a row, ``z`` a row), the card's
    and the CPU's each against them, else the card's against the CPU's,
    within LOGIT_ATOL plus LOGIT_RTOL times the largest |output| of the
    row (for one output a row, the output itself). Returns (largest |card
    - reference|, largest |card - CPU|, outputs where card and CPU differ
    by more than LOGIT_ATOL plus LOGIT_RTOL times the output itself,
    largest |CPU - reference|: None without float64 outputs)."""
    from waveformml_tpu_torch.detector import Z_NORMALIZATION_FACTOR
    from waveformml_tpu_torch.engineering.se_mask import seg_status_maps

    stats = [0.0, 0.0, 0, None]

    def same(a, b, label):
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes(), label

    def close(a, b, ref, label, scale=1.0, offset=0.0):
        a = np.asarray(a, np.float64) / scale + offset
        b = np.asarray(b, np.float64) / scale + offset
        assert np.isfinite(a).all() and np.isfinite(b).all(), label
        if a.size == 0:
            return
        want = b if ref is None else np.asarray(ref, np.float64).reshape(a.shape)
        mag = np.abs(want).reshape(len(want), -1).max(1).reshape((-1,) + (1,) * (a.ndim - 1))
        tol = LOGIT_ATOL + LOGIT_RTOL * mag
        for x, who in ((a, "card"), (b, "CPU"))[:1 if ref is None else 2]:
            err = np.abs(x - want)
            assert (err <= tol).all(), (
                f"{label}: the {who}'s outputs against {'the CPU' if ref is None else 'float64'}: "
                f"{int((err > tol).sum())} of {err.size} beyond tolerance, largest |difference| "
                f"{float(err.max()):.3g}")
        stats[0] = max(stats[0], float(np.abs(a - want).max()))
        stats[1] = max(stats[1], float(np.abs(a - b).max()))
        stats[2] += int((np.abs(a - b) > LOGIT_ATOL + LOGIT_RTOL * np.abs(b)).sum())
        if ref is not None:
            stats[3] = max(stats[3] or 0.0, float(np.abs(b - want).max()))

    assert got.dtype == want.dtype and got.shape == want.shape == inp.shape
    if kind != "phys":
        field, cols, scale, offset = {"z": ("EZ", [1], Z_NORMALIZATION_FACTOR, 0.5),
                                      "irn": ("phys", [4, 5, 6], 1.0, 0.0),
                                      "irnim": ("phys", [2, 3, 4, 5, 6], 1.0, 0.0)}[kind]
        for name in want.dtype.names:
            if name != field:
                same(got[name], want[name], name)
        keep = [c for c in range(want[field].shape[1]) if c not in cols]
        same(got[field][:, keep], want[field][:, keep], field)
        assert not np.allclose(got[field][:, cols], inp[field][:, cols]), "nothing swapped"
        close(got[field][:, cols], want[field][:, cols], z if kind == "z" else scores, field,
              scale, offset)
        return tuple(stats)
    _, bl, br = seg_status_maps(None)
    c = inp["coord"]
    left, right = bl[c[:, 0], c[:, 1]] == 1, br[c[:, 0], c[:, 1]] == 1
    se, de, dead = (left | right) & ~(left & right), ~left & ~right, left & right
    assert se.any() and de.any()
    for name in ("evt", "seg", "t", "PE", "PID", "E_SE", "PSD_SE"):
        same(got[name], want[name], name)
    # the classifier's 5 scores at single-ended rows, copies elsewhere
    placed = ("E", "rand", "dt", "y", "PSD")
    close(np.stack([got[n][se] for n in placed], 1), np.stack([want[n][se] for n in placed], 1),
          None if scores is None else scores[se], "scores")
    for name in placed[:1] + placed[2:]:
        same(got[name][~se], want[name][~se], name)
    same(got["rand"][dead], want["rand"][dead], "rand")
    if z is None:   # the input's z
        same(got["y_SE"], want["y_SE"], "y_SE")
    else:           # the Z model's, at single-ended rows
        close(got["y_SE"][se], want["y_SE"][se], z[se], "y_SE", Z_NORMALIZATION_FACTOR, 0.5)
        same(got["y_SE"][~se], want["y_SE"][~se], "y_SE")
    drawn = np.zeros(got["Esmear_SE"].shape, bool)
    drawn[np.flatnonzero(se), np.where(left, 1, 0)[se]] = True
    for rec in (got, want):
        assert ((rec["rand"][de] >= 0) & (rec["rand"][de] < 1)).all()
        assert ((rec["Esmear_SE"][drawn] >= 0) & (rec["Esmear_SE"][drawn] < 1)).all()
    same(got["Esmear_SE"][~drawn], want["Esmear_SE"][~drawn], "Esmear_SE")
    return tuple(stats)


def check_capture_under_threads(cfg, state, big, small, tag="capture under threads") -> None:
    """A new layout captured while another thread makes CUDA calls the
    whole time (waits on and queries an event of an earlier chunk, takes
    and frees pinned buffers), as the writers' fetch workers do: the
    capture succeeds, the other thread's calls all return, and the chunk's
    outputs match the eager forward."""
    import threading

    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.inference.model import InferenceModel

    server = InferenceModel(cfg, state)
    server(*big)
    pending = server.dispatch(*big)
    stop, calls, errors, window = threading.Event(), [], [], []
    capture = server._capture

    def timed_capture(*args):
        t0 = time.perf_counter()
        g = capture(*args)
        window.append((t0, time.perf_counter()))
        return g

    def spin():
        while not stop.is_set():
            try:
                pending.ready.synchronize()
                pending.ready.query()
                torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True)
                calls.append(time.perf_counter())
            except Exception as e:  # raised again below
                errors.append(e)
                return

    server._capture = timed_capture
    worker = threading.Thread(target=spin, name="capture-under-threads")
    worker.start()
    try:
        while not calls and not errors:
            time.sleep(0.001)
        out = server(*small)
    finally:
        stop.set()
        worker.join()
    server.fetch(pending)
    assert not errors, errors
    assert len(window) == 1 and len(server.graphs) == 2, (window, len(server.graphs))
    inside = sum(window[0][0] <= t <= window[0][1] for t in calls)
    assert inside > 0, "no call of the other thread fell inside the capture"
    task = server.task
    c, f = small
    n_events = int(c[:, -1].max()) + 1
    direct = task.apply_model(prepared(task, FileBlock(c, f, np.zeros(n_events, np.int64))))
    direct = direct[:out.shape[0]].cpu().numpy()
    np.testing.assert_allclose(out, direct, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    print(f"{tag}: a layout of {c.shape[0]} rows captured in "
          f"{(window[0][1] - window[0][0]) * 1e3:.3f} ms while another thread made "
          f"{inside} rounds of event waits, event queries and pinned allocations inside "
          f"the capture ({len(calls)} in all); the capture held, its outputs match the "
          f"eager forward (largest |difference| {float(np.abs(out - direct).max()):.3g})",
          flush=True)


def run_writers() -> None:
    """The prediction writers on the card, each through its own pipeline
    (reader, dispatch, fetch workers, table writer), over
    ``WRITER_READS`` read chunks of seeded in-memory records made as the
    synthetic HDF5 writers make them (about 2.5 rows an event), the last
    one short (a layout first seen mid-stream, captured under the running
    pipeline): Z with a calgroup (gain normalisation and the per-row gather
    on the card) and without (WaveformPairNorm), IRN (SubMPSD.json: K1,
    K2), IRNIM in swap mode (WaveformPairNorm) and in PhysPulse mode (with a
    calgroup; K1) and ZAndClass (the Z model and the IRNIM classifier back
    to back; K1). The HDF5 reader and table writer are the in-memory
    stand-ins of ``datasets/synthetic.py``. Each writer's rows are held to
    the same writer's run with ``device="cpu"`` (the plain versions); its
    rows/s, events/s, stage seconds, dispatch phases, graphs, replays and
    launches printed."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import (in_memory_writer, wfnorm_records,
                                                         wfpair_cal_records)
    from waveformml_tpu_torch.inference import prediction_writer as pw
    from waveformml_tpu_torch.io.compound_types import WaveformPairCal, WaveformPairNorm
    from waveformml_tpu_torch.io.hdf5 import available
    from waveformml_tpu_torch.io.sql import write_synthetic_caldb
    from waveformml_tpu_torch.ops.sparse import normalize_waveforms
    from waveformml_tpu_torch.registry import retrieve_class

    with tempfile.TemporaryDirectory() as tmp:
        caldb = os.path.join(tmp, "cal.db")
        write_synthetic_caldb(caldb, WRITER_CALGROUP, seed=SEED + 40)
        os.environ["PROSPECT_CALDB"] = caldb
        configs = writer_configs(tmp)
        t0 = time.perf_counter()
        cal_all = wfpair_cal_records(WRITER_EVENTS, seed=SEED + 41)
        norm_all = wfnorm_records(WRITER_EVENTS, seed=SEED + 42)
        made = time.perf_counter() - t0
        cal_t, norm_t = WaveformPairCal(), WaveformPairNorm()
        cal = stream_prefix(cal_all, cal_t, 2048, WRITER_READS, WRITER_TAIL_ROWS)
        cal_zc = stream_prefix(cal_all, cal_t, 1024, WRITER_READS, WRITER_TAIL_ROWS // 2)
        norm = stream_prefix(norm_all, norm_t, 2048, WRITER_READS, WRITER_TAIL_ROWS)
        print(f"writer phase: records made in {made:.2f} s; WaveformPairCal {len(cal)} rows "
              f"({len(cal_zc)} for ZAndClass), WaveformPairNorm {len(norm)} rows; the HDF5 "
              f"reader and table writer did not run ("
              f"{'h5py is installed, but ' if available() else 'h5py is not installed; '}"
              f"the writers read and write the in-memory stand-ins of datasets/synthetic.py)",
              flush=True)

        # seeded weights, BatchNorm statistics from the features each model
        # sees: gain-normalised ADC counts, or the normalised pulses
        gains = pw._gain_factors(WRITER_CALGROUP)
        head = cal[:4096]
        cal_feats = normalize_waveforms(head["coord"].copy(), head["waveform"], gains)
        norm_feats = norm[:4096]["pulse"]
        ckpts = {}
        for seed, (name, cfg_name, coords, feats) in enumerate((
                ("z", "z", head["coord"], cal_feats),
                ("z_norm", "z_norm", norm[:4096]["coord"], norm_feats),
                ("irn", "irn", norm[:4096]["coord"], norm_feats),
                ("irnim", "irnim", norm[:4096]["coord"], norm_feats),
                ("irnim_cal", "irnim", head["coord"], cal_feats))):
            cfg = load_config(configs[cfg_name])
            task_cls = retrieve_class(cfg.run_config.run_class)
            n = coords.shape[0]
            n_events = int(coords[:, -1].max()) + 1
            labels = (np.zeros(n, np.float32) if task_cls.labels_per_row
                      else np.zeros(n_events, np.int64))
            block = FileBlock(coords.astype(np.int32), np.ascontiguousarray(feats), labels)
            ckpts[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(seeded_state(cfg, SEED + 50 + seed, block), ckpts[name])
        big = (norm[:2000]["coord"], norm[:2000]["pulse"])
        small = (norm[:300]["coord"], norm[:300]["pulse"])
        check_capture_under_threads(load_config(configs["irn"]),
                                    torch.load(ckpts["irn"], weights_only=True),
                                    big, small)

        # the models' float64 outputs over each stream (the features the
        # card gets: the gain products are float32 on both)
        t0 = time.perf_counter()
        cal_feats = normalize_waveforms(cal["coord"].copy(), cal["waveform"], gains)
        ref = {"z": reference64(configs["z"], ckpts["z"], cal["coord"], cal_feats),
               "z_norm": reference64(configs["z_norm"], ckpts["z_norm"], norm["coord"],
                                     norm["pulse"]),
               "irnim": reference64(configs["irnim"], ckpts["irnim"], norm["coord"],
                                    norm["pulse"]),
               "irnim_cal": reference64(configs["irnim"], ckpts["irnim_cal"], cal["coord"],
                                        cal_feats)}
        print(f"writer phase: float64 outputs of the Z and IRNIM models over the streams on "
              f"the CPU in {time.perf_counter() - t0:.2f} s", flush=True)
        zc = len(cal_zc)

        cal_kw = {"calgroup": WRITER_CALGROUP}
        cases = (
            ("Z, calgroup", pw.ZPredictionWriter, "run_WFCalFilteredSE.h5", cal,
             [configs["z"], ckpts["z"]], dict(cal_kw, datatype="WaveformPairCal"), 2048, "z",
             (), None, ref["z"]),
            ("Z, no calgroup", pw.ZPredictionWriter, "run_WFNorm.h5", norm,
             [configs["z_norm"], ckpts["z_norm"]], {}, 2048, "z", (), None, ref["z_norm"]),
            ("IRN", pw.IRNPredictionWriter, "run_WFNorm.h5", norm,
             [configs["irn"], ckpts["irn"]], {}, 2048, "irn",
             ("subm_conv_rows", "site_grouped_matmul"), None, None),
            ("IRNIM swap", pw.IRNIMPredictionWriter, "run_WFNorm.h5", norm,
             [configs["irnim"], ckpts["irnim"]], {}, 2048, "irnim", ("subm_conv_rows",),
             ref["irnim"], None),
            ("IRNIM PhysPulse", pw.IRNIMPredictionWriter, "run_WFCalFilteredSE.h5", cal,
             [configs["irnim"], ckpts["irnim_cal"]], dict(cal_kw, datatype="PhysPulse"), 2048,
             "phys", ("subm_conv_rows",), ref["irnim_cal"], None),
            ("ZAndClass", pw.ZAndClassWriter, "run_WFCalFilteredSE.h5", cal_zc,
             [configs["z"], ckpts["z"], configs["irnim"], ckpts["irnim_cal"]], dict(cal_kw),
             1024, "phys", ("subm_conv_rows",), ref["irnim_cal"][:zc], ref["z"][:zc]),
        )
        out_path = os.path.join(tmp, "never_written_Phys.h5")
        for tag, writer_cls, name, records, args, kwargs, read, kind, kernels, scores, z in cases:
            table = {(cal_t if "waveform" in records.dtype.names else norm_t).name: records}
            stand_in = in_memory_writer(writer_cls, table)
            writer = stand_in(out_path, name, *args, n_rows_per_read=read, **kwargs)
            models = [writer.model] + ([writer.class_model]
                                       if hasattr(writer, "class_model") else [])
            watches = [PipelineWatch(m) for m in models]
            zero_counts()
            t0 = time.perf_counter()
            writer.write_predictions()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eager = read_counts()
            replayed = {k: sum(m.replay_launches()[k] for m in models) for k in eager}
            got = writer.tables[writer.data_type.name]
            assert not os.path.exists(out_path)
            for m, w in zip(models, watches):
                assert w.dispatched == w.fetched == WRITER_READS, (w.dispatched, w.fetched)
                assert sum(g.replays for g in m.graphs.values()) == WRITER_READS
                # the full chunks' layout, and the short last chunk's, first
                # seen after WRITER_READS - 1 chunks
                assert len(m.graphs) >= 2 and len(w.in_flight_at_capture) == len(m.graphs)
            for k in kernels:
                assert replayed[k] > 0, (tag, replayed)
            cpu_writer = stand_in(out_path, name, *args, n_rows_per_read=read, device="cpu",
                                  **kwargs)
            t1 = time.perf_counter()
            cpu_writer.write_predictions()
            cpu_wall = time.perf_counter() - t1
            err_ref, err_cpu, beyond, cpu_ref = compare_writer_rows(
                got, cpu_writer.tables[cpu_writer.data_type.name], records, kind, scores, z)
            n_rows = records.shape[0]
            ev = records["coord"][:, 2]
            n_events = int(1 + np.count_nonzero(ev[1:] != ev[:-1]))
            stages = {k: round(v * 1e3, 3) for k, v in writer.stage_seconds.items()}
            phases = [{k: round(v * 1e3, 3) for k, v in m.dispatch_phases.items()}
                      for m in models]
            print(f"writer {tag}: {n_rows} rows, {n_events} events, {WRITER_READS} reads of "
                  f"{read} rows in {wall:.4f} s = {n_rows / wall:.1f} rows/s, "
                  f"{n_events / wall:.1f} events/s (wall, host clock); stage ms {stages}; "
                  f"dispatch phase ms {phases}; graphs captured "
                  f"{[len(m.graphs) for m in models]}, chunks in flight at each capture "
                  f"{[w.in_flight_at_capture for w in watches]}, capture ms "
                  f"{[round(m.capture_s * 1e3, 3) for m in models]}; replays "
                  f"{[sum(g.replays for g in m.graphs.values()) for m in models]}; launches "
                  f"from replays {replayed}, from eager warm-ups {eager}; rows match the CPU "
                  f"run ({cpu_wall:.2f} s): row order and copied fields equal; the model's "
                  f"outputs, {'card' if scores is None and z is None else 'card and CPU'}, "
                  f"within {LOGIT_ATOL} + {LOGIT_RTOL} x the row's largest |output| of "
                  f"{'the CPU run' if scores is None and z is None else 'float64'} (card "
                  f"largest |difference| {err_ref:.3g}"
                  f"{'' if cpu_ref is None else f', CPU {cpu_ref:.3g}'}); card against CPU largest "
                  f"|difference| {err_cpu:.3g}, {beyond} outputs beyond {LOGIT_ATOL} + "
                  f"{LOGIT_RTOL} x the output",
                  flush=True)
        del os.environ["PROSPECT_CALDB"]


# -- the evaluation ----------------------------------------------------------------------

class RecordingLogger:
    """Records the tags an evaluator logs; each figure is closed at once."""

    def __init__(self):
        self.figures, self.histograms, self.scalars = set(), set(), {}

    def log_figure(self, tag, fig, step=0, close=True):
        import matplotlib.pyplot as plt

        self.figures.add(tag)
        plt.close(fig)

    def log_histogram(self, tag, values, step=0):
        self.histograms.add(tag)

    def log_scalar(self, tag, value, step=0):
        self.scalars[tag] = float(value)

    def log_scalars(self, values, step=0):
        for k, v in values.items():
            self.log_scalar(k, v, step)

    def flush(self):
        pass


@contextlib.contextmanager
def recorded_batches(evaluator_cls):
    """Every (host batch, test outputs) that evaluators of a class are fed
    while the block runs, in order."""
    calls, original = [], evaluator_cls.add_batch

    def add_batch(self, block, db, test_out):
        calls.append((db, test_out))
        return original(self, block, db, test_out)

    evaluator_cls.add_batch = add_batch
    try:
        yield calls
    finally:
        evaluator_cls.add_batch = original


def array_differences(got, want) -> list:
    """The accumulated arrays (``evaluation.accumulated_arrays``) in which
    two evaluators differ: integer-valued ones (counts) at any entry, the
    others by more than EVAL_RTOL·|want| + EVAL_ATOL·max|want|."""
    from waveformml_tpu_torch.evaluation import accumulated_arrays

    a, b = accumulated_arrays(got), accumulated_arrays(want)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    out = []
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        if np.array_equal(x, y, equal_nan=True):
            continue
        finite = np.isfinite(y)
        counts = np.array_equal(np.isfinite(x), finite) and all(
            np.array_equal(v[finite], np.round(v[finite])) for v in (x, y))
        scale = float(np.abs(y[finite]).max()) if finite.any() else 0.0
        if counts or not np.allclose(x, y, rtol=EVAL_RTOL, atol=EVAL_ATOL * scale,
                                     equal_nan=True):
            out.append(k)
    return out


def run_evaluate(tag, cfg_path, state, train, val, test, output_key, calgroup=None,
                 work_dir=None):
    """``python -m waveformml_tpu_torch.evaluate``'s ``run`` on the card
    over in-memory test chunks, from a checkpoint written by a 1-epoch fit
    from ``state`` (into ``work_dir/<tag>/version_0``, which outlives the
    call, where given), with every kernel's count set to 0 just before and read
    just after (each launch of the model's kernels a test chunk asserted),
    then again with ``--device cpu`` (the plain versions). Asserts that the
    evaluator was built and fed every chunk; holds the test outputs
    (``output_key``) of card and CPU to LOGIT_RTOL, LOGIT_ATOL, the
    predictions that differ to argmax ties within that tolerance, and the
    evaluators' accumulated arrays to each other (``array_differences``);
    where outputs within the tolerance make some differ (a flipped tie, a
    value on a histogram's bin edge), an evaluator fed the CPU run's host
    batches with the card's outputs must equal the card's. Prints the test
    metrics, the test pass's events/s and per-chunk split (host prep, copy
    in, device forward, copy back, ``add_batch``), ``dump()``'s ms, and
    the count of figures where matplotlib renders them. Returns the card
    run's launches and the checkpoint's path."""
    from waveformml_tpu_torch import evaluate
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.engineering.callbacks import LoggingCallback
    from waveformml_tpu_torch.evaluation import accumulated_arrays
    from waveformml_tpu_torch.io.sql import write_synthetic_caldb

    figures = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        if calgroup:
            os.environ["PROSPECT_CALDB"] = os.path.join(tmp, "cal.db")
            write_synthetic_caldb(os.environ["PROSPECT_CALDB"], calgroup, seed=SEED + 70)
        try:
            cfg = load_config(cfg_path)
            ckpt_dir = os.path.join(work_dir, tag) if work_dir else tmp
            fit = make_trainer(cfg, state, plain=False,
                               checkpoint_dir=os.path.join(ckpt_dir, "version_0"), max_epochs=1)
            t0 = time.perf_counter()
            fit.fit(BlockDataModule(train, val))
            print(f"{tag} evaluate: checkpoint of a 1-epoch fit over {len(train)} chunks in "
                  f"{time.perf_counter() - t0:.2f} s: {os.path.basename(fit.best_ckpt_path)}",
                  flush=True)
            argv = [cfg_path, fit.best_ckpt_path] + (["-c", calgroup] if calgroup else [])
            evaluator_cls = type(fit.task.make_evaluator())
            runs = {}
            for device in ("cuda", "cpu"):
                args = evaluate.build_parser().parse_args(argv + ["--device", device])
                config = load_config(cfg_path)
                evaluate.apply_overrides(config, args)
                logger = RecordingLogger() if figures else None
                out = io.StringIO()
                with recorded_batches(evaluator_cls) as batches, contextlib.redirect_stdout(out):
                    zero_counts()
                    t0 = time.perf_counter()
                    res = evaluate.run(config, args, BlockDataModule([], [], test),
                                       logger=logger)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = read_counts()
                runs[device] = dict(res, batches=batches, wall=wall, launches=launches,
                                    logger=logger, printed=out.getvalue().strip())
        finally:
            os.environ.pop("PROSPECT_CALDB", None)
    card, cpu = runs["cuda"], runs["cpu"]
    trainer = card["trainer"]
    model = trainer.task.model
    want_launches = training_launches(model, 0, len(test))
    assert card["launches"] == want_launches, (tag, card["launches"], want_launches)
    assert not any(cpu["launches"].values()), cpu["launches"]
    for run in (card, cpu):
        ev = run["trainer"].task.evaluator
        assert isinstance(ev, evaluator_cls) and len(run["batches"]) == len(test), (
            tag, type(ev), len(run["batches"]))
        assert set(run["test"]) and all(np.isfinite(v) for v in run["test"].values())
    for k in card["test"]:
        assert np.isclose(card["test"][k], cpu["test"][k], rtol=LOGIT_RTOL, atol=LOGIT_ATOL), (
            tag, k, card["test"], cpu["test"])

    # the outputs: card against CPU; argmax flips only at ties within that
    flips = 0
    for (db_g, got), (db_w, want) in zip(card["batches"], cpu["batches"]):
        assert sorted(db_g) == sorted(db_w)
        for k in db_w:
            assert np.array_equal(db_g[k], db_w[k]), (tag, k)
        g, w = np.asarray(got[output_key]), np.asarray(want[output_key])
        assert g.shape == w.shape and np.isfinite(g).all(), (tag, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=tag)
        if "pred" in want:
            flip = np.asarray(got["pred"]) != np.asarray(want["pred"])
            top2 = np.sort(w[flip], axis=1)[:, -2:]
            gap = top2[:, 1] - top2[:, 0]
            tie = 2 * (LOGIT_ATOL + LOGIT_RTOL * np.abs(w[flip]).max(axis=1))
            assert (gap <= tie).all(), (tag, gap, tie)
            flips += int(flip.sum())
    card_ev, cpu_ev = card["trainer"].task.evaluator, cpu["trainer"].task.evaluator
    if hasattr(cpu_ev, "confusion"):
        assert np.abs(card_ev.confusion - cpu_ev.confusion).sum() <= 2 * flips, tag
    differ = array_differences(card_ev, cpu_ev)
    explained = ""
    if differ:
        replay = cpu["trainer"].task.make_evaluator()
        for (db, _), (_, out) in zip(cpu["batches"], card["batches"]):
            replay.add_batch(None, db, out)
        assert not array_differences(card_ev, replay), (tag, array_differences(card_ev, replay))
        explained = (f"; {len(differ)} differ ({differ}), all from the outputs: an evaluator "
                     f"fed the CPU run's batches with the card's outputs equals the card's")
    n_arrays = len(accumulated_arrays(cpu_ev))

    phases = trainer.test_phases
    events = sum(p["events"] for p in phases)
    test_wall = sum(p["wall_s"] for p in phases)
    per = {k: statistics.mean(p[k] for p in phases) * 1e3
           for k in ("host_prep_s", "h2d_s", "copy_back_s", "collect_s", "wall_s")}
    timed = [p["device_ms"] for p in phases if p["device_ms"] is not None]
    forward = statistics.mean(timed) if timed else float("nan")
    dump = [cb.dump_seconds for cb in trainer.callbacks if isinstance(cb, LoggingCallback)]
    print(f"{tag} evaluate: {card['printed']}", flush=True)
    print(f"{tag} evaluate: evaluator {type(card_ev).__name__} fed {len(card['batches'])} "
          f"chunks, {events} events; run() {card['wall']:.3f} s (wall, host clock; CPU run "
          f"{cpu['wall']:.3f} s); test pass {test_wall:.4f} s = {events / test_wall:.1f} "
          f"events/s; per chunk (ms, means): host prep {per['host_prep_s']:.3f}, copy in "
          f"{per['h2d_s']:.3f}, device forward {forward:.4f} (CUDA events), copy back "
          f"{per['copy_back_s']:.3f}, add_batch (host) {per['collect_s']:.3f}, wall "
          f"{per['wall_s']:.3f}; device busy share {forward * len(phases) / (test_wall * 1e3):.4f}; "
          f"dump() {dump[0] * 1e3:.3f} ms; launches {card['launches']}", flush=True)
    print(f"{tag} evaluate: outputs ({output_key}) match the CPU run (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}); {flips} argmax ties flipped; host batches equal; "
          f"{n_arrays} accumulated arrays held to the CPU run's (counts exactly, the rest to "
          f"rtol={EVAL_RTOL} + {EVAL_ATOL} x the array's largest |value|){explained}",
          flush=True)
    if figures:
        assert card["logger"].figures == cpu["logger"].figures and card["logger"].figures
        print(f"{tag} evaluate: dump() rendered {len(card['logger'].figures)} figures and "
              f"{len(card['logger'].histograms)} histograms, the same tags as the CPU run's",
              flush=True)
    else:
        print(f"{tag} evaluate: dump() was not rendered: matplotlib is not installed on this "
              f"machine (the pass ran without a logger, so dump() returned at once)",
              flush=True)
    return card["launches"], fit.best_ckpt_path


def run_evaluation(state, train, val, work_dir, waveform) -> tuple:
    """The evaluate phase: SubMPSD.json (fp32, its shipped widths, the
    serving run's weights; K1 and K2) over EVAL_CHUNKS test chunks of 4096
    events, SegQuantifier.json (K1) and SingleEndedZCNN.json with a
    calibration group (``Calibrator``, ``CalCurve``, ``calc_calib_z_E``)
    over EVAL_SEGMENT_CHUNKS, each from seeded weights, and
    SingleWaveformTCN.json (``TensorEvaluator``) over EVAL_SEGMENT_CHUNKS
    chunks of 16384 waveforms from ``waveform``'s state and blocks
    (``run_waveform_nets``), each checkpoint kept under ``work_dir``.
    Returns the SubMPSD run's launches and, for each config, (config path,
    checkpoint, test chunks)."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block, segment_block

    n_samples = load_config(CONFIG).system_config.n_samples
    rng = np.random.default_rng(SEED + 60)
    test = [labelled_block(rng, EVENTS_PER_CHUNK, n_samples) for _ in range(EVAL_CHUNKS)]
    launches, ckpt = run_evaluate("SubMPSD.json", CONFIG, state, train, val, test, "logits",
                                  work_dir=work_dir)
    assert launches["subm_conv_rows"] > 0 and launches["site_grouped_matmul"] > 0, launches
    checkpoints = {CONFIG: (ckpt, test)}
    for i, (path, label, key, calgroup) in enumerate((
            (CONFIG_SEGQ, "ez", "predictions", None),
            (CONFIG_Z, "z", "predictions", EVAL_CALGROUP))):
        cfg = load_config(path)
        n = cfg.system_config.n_samples
        rng = np.random.default_rng(SEED + 61 + i)
        blocks = [segment_block(rng, EVENTS_PER_CHUNK, n, label=label)
                  for _ in range(2 + 1 + EVAL_SEGMENT_CHUNKS)]
        seg_state = seeded_state(cfg, SEED + 63 + i, blocks[0])
        _, ckpt = run_evaluate(os.path.basename(path), path, seg_state, blocks[:2],
                               blocks[2:3], blocks[3:], key, calgroup, work_dir=work_dir)
        checkpoints[path] = (ckpt, blocks[3:])
    path = CONFIGS_WAVEFORM[0]
    tcn_state, tcn_train, tcn_val = waveform[path]
    rng = np.random.default_rng(SEED + 64)
    test = [waveform_chunk(rng, WAVEFORMS_PER_CHUNK, load_config(path).system_config.n_samples)
            for _ in range(EVAL_SEGMENT_CHUNKS)]
    _, ckpt = run_evaluate(os.path.basename(path), path, tcn_state, tcn_train[:2], tcn_val,
                           test, "predictions", work_dir=work_dir)
    checkpoints[path] = (ckpt, test)
    return launches, checkpoints


# -- the export -------------------------------------------------------------------------

#: run in a fresh process by ``run_export``, which imports torch and the port
#: only: reloads each (program, batch, output) of its arguments with
#: ``load_exported`` and runs it on the card, K1's and K2's counts set to 0
#: just before and read just after; prints one JSON line a program
RELOAD_SCRIPT = r"""
import json
import sys

import torch

from waveformml_tpu_torch.engineering.trainer import load_exported
from waveformml_tpu_torch.ops.row_conv import subm_conv_rows
from waveformml_tpu_torch.ops.site_head import site_grouped_matmul

args = sys.argv[1:]
for program, batch, out_path in zip(args[0::3], args[1::3], args[2::3]):
    db = {k: v.cuda() for k, v in torch.load(batch).items()}
    run = load_exported(program)
    torch.cuda.synchronize()
    subm_conv_rows.launches = site_grouped_matmul.launches = 0
    out = run(db)
    torch.cuda.synchronize()
    launches = {"subm_conv_rows": subm_conv_rows.launches,
                "site_grouped_matmul": site_grouped_matmul.launches}
    torch.save(out.cpu(), out_path)
    foreign = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "flax", "waveformml_tpu"})
    print(json.dumps({"program": program, "shape": list(out.shape), "dtype": str(out.dtype),
                      "finite": bool(torch.isfinite(out).all()),
                      "sum_abs": float(out.abs().sum()), "first": out.flatten()[:6].tolist(),
                      "launches": launches, "foreign_modules": foreign}), flush=True)
"""


def exported_ops(path: str) -> dict:
    """The custom-op nodes of an exported program's graph, counted by op."""
    program = torch.export.load(path)
    ops = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("waveformml."):
            ops[target] = ops.get(target, 0) + 1
    return ops


def loaded_trainer(cfg_path: str, ckpt: str):
    """A fresh Trainer on the card over the config's task, the checkpoint's
    weights loaded."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, retrieve_class(cfg.run_config.run_class)(cfg))
    trainer.load_checkpoint(ckpt)
    return trainer


def check_ops_on_card(trainer, db) -> None:
    """``torch.library.opcheck`` of the five custom ops with CUDA tensors at
    SubMPSD.json's shapes: its first conv (K1, K4), its head (K2, K5) and
    the first PMT's half of the chunk's waveforms (K3)."""
    from waveformml_tpu_torch.detector import NX, NY

    model = trainer.task.model
    conv, head = model.stack.l0, model.head0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    mask, feats = db["mask"], db["feats"].float().contiguous()
    n, n_events = mask.shape[0], db["labels"].shape[0]
    plan = db[f"plan_{conv.plan_key}"]
    weight, bias = conv.weight.detach(), conv.bias.detach()
    g = torch.randn(n, weight.shape[2], device="cuda", generator=gen)
    rows = torch.relu(torch.randn(n, head.cin, device="cuda", generator=gen))
    rows = torch.where(mask[:, None], rows, 0.0).contiguous()
    k3 = head.weight.detach().view(head.cin, NX * NY, head.features)
    layout = (db["plan_site_take"], db["plan_site_ev"], db["plan_site_s"], n_events)
    d_out = torch.randn(n_events, head.features, device="cuda", generator=gen)
    n_samples = trainer.config.system_config.n_samples
    cases = {"subm_conv_rows": (feats, plan, weight, bias, mask),
             "subm_conv_rows_wgrad": (feats, plan, g, mask, True),
             "site_grouped_matmul": (rows, k3, *layout, head.bias.detach()),
             "site_grouped_matmul_bwd": (d_out, rows, k3, *layout, True),
             "waveform_features": (feats[:, :n_samples].contiguous(),)}
    for name, args in cases.items():
        t0 = time.perf_counter()
        result = torch.library.opcheck(getattr(torch.ops.waveformml, name).default, args)
        assert set(result.values()) == {"SUCCESS"}, (name, result)
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        print(f"export opcheck waveformml::{name} on the card at {shapes}: {result} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)


#: the kernels the dispatch timing reroutes: (module, public name)
ROUTED = (("row_conv", "subm_conv_rows"), ("row_conv", "subm_conv_rows_wgrad"),
          ("site_head", "site_grouped_matmul"), ("site_head", "site_grouped_matmul_bwd"),
          ("waveform_features", "waveform_features"))
#: the same CUDA implementations as ``torch.library.custom_op`` ops, made
#: once (``custom_op_twins``), for the dispatch timing only
_TWINS = {}


def custom_op_twins() -> dict:
    """The CUDA implementations of the five kernels registered a second
    time, through ``torch.library.custom_op`` in a namespace of their own,
    which is how the ops were first written: ``{public name: op}``."""
    import importlib

    if not _TWINS:
        for module, name in ROUTED:
            fn = getattr(importlib.import_module(f"waveformml_tpu_torch.ops.{module}"),
                         f"{name}_cuda")
            _TWINS[name] = torch.library.custom_op(f"waveformml_timing::{name}",
                                                   mutates_args=(), device_types="cuda")(fn)
    return _TWINS


@contextlib.contextmanager
def kernel_calls(route: str):
    """Inside the block, the kernels' public wrappers call them through
    ``route``: "op" (the port's ops, as they are), "raw" (the CUDA
    implementations called directly, past the dispatcher: the ctypes
    launches as they were before the kernels were ops) or "custom_op"
    (``custom_op_twins``); for a timing only."""
    import importlib

    modules = [(importlib.import_module(f"waveformml_tpu_torch.ops.{m}"), n) for m, n in ROUTED]
    saved = [(m, n, getattr(m, f"{n}_op")) for m, n in modules]
    try:
        for m, n in modules:
            if route == "raw":
                setattr(m, f"{n}_op", getattr(m, f"{n}_cuda"))
            elif route == "custom_op":
                setattr(m, f"{n}_op", custom_op_twins()[n])
        yield
    finally:
        for m, n, op in saved:
            setattr(m, f"{n}_op", op)


def routed_times_ms(fn, routes, calls: int = DISPATCH_CALLS,
                    rounds: int = DISPATCH_ROUNDS) -> dict:
    """Host ms a call of ``fn()`` through each route of ``kernel_calls``:
    ``rounds`` rounds of blocks of ``calls`` calls, each round in the order
    of ``routes`` and back (op, raw, raw, op), each block's time to enqueue
    its calls (host clock, before its wait for the card) and to finish them
    (to the end of that wait); medians over each route's blocks."""
    def block(route):
        with kernel_calls(route):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return (t1 - t0) * 1e3 / calls, (t2 - t0) * 1e3 / calls

    for route in routes:
        with kernel_calls(route):
            fn()
            fn()
    runs = {route: [] for route in routes}
    for _ in range(rounds):
        for route in (*routes, *routes[::-1]):
            runs[route].append(block(route))
    return {route: {"enqueue_ms": statistics.median(r[0] for r in v),
                    "wall_ms": statistics.median(r[1] for r in v)} for route, v in runs.items()}


def run_dispatch_timing(cfg_path: str, state, train, card: str) -> dict:
    """What the op dispatch costs on the host: a K1 call (SubMPSD.json's
    first conv, through its public wrapper), a K2 call (its head) and an
    eager SubMPSD.json training step, each through the port's ops against
    the raw ctypes calls (``routed_times_ms``); then again with
    ``torch.library.custom_op`` twins of the ops as a third route (the
    first such call imports torch._dynamo into the process). Prints each
    with the card's name and power limit."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows
    from waveformml_tpu_torch.ops.site_head import site_grouped_matmul

    trainer = make_trainer(load_config(cfg_path), state, plain=False)
    db = trainer.device_batch(train[0])[0]
    model = trainer.task.model
    conv, head = model.stack.l0, model.head0
    k1 = (db["feats"].float().contiguous(), db[f"plan_{conv.plan_key}"],
          conv.weight.detach(), conv.bias.detach(), db["mask"])
    rows = torch.relu(torch.randn(db["mask"].shape[0], head.cin, device="cuda"))
    k2 = (rows, head.weight.detach().view(head.cin, NX * NY, head.features),
          db["plan_site_take"], db["plan_site_ev"], db["plan_site_s"],
          db["labels"].shape[0], head.bias.detach())
    cases = (("K1 subm_conv_rows call", lambda: subm_conv_rows(*k1), "us"),
             ("K2 site_grouped_matmul call", lambda: site_grouped_matmul(*k2), "us"),
             ("SubMPSD.json training step", lambda: trainer.training_step(db), "ms"))
    out = {}
    for routes in (("op", "raw"), ("op", "raw", "custom_op")):
        for name, fn, unit in cases:
            t = routed_times_ms(fn, routes)
            out[(name, routes)] = t
            scale = 1e3 if unit == "us" else 1.0
            times = "; ".join(f"{r} {t[r]['enqueue_ms'] * scale:.4f} / {t[r]['wall_ms'] * scale:.4f}"
                              for r in routes)
            over = ", ".join(f"{r} {(t[r]['wall_ms'] - t['raw']['wall_ms']) * scale:+.4f} {unit} "
                             f"({t[r]['wall_ms'] / t['raw']['wall_ms'] - 1:+.2%})"
                             for r in routes if r != "raw")
            print(f"export dispatch, {name}, routes {'/'.join(routes)} ({unit} a call to "
                  f"enqueue / to finish, medians of {2 * DISPATCH_ROUNDS} blocks of "
                  f"{DISPATCH_CALLS}): {times}; over raw: {over}; {card}", flush=True)
    return out


def run_export(checkpoints, state, train, val, work_dir, card: str) -> dict:
    """The export phase. For SubMPSD.json (through ``evaluate.run`` with
    ``--script``, what ``python -m waveformml_tpu_torch.evaluate --script``
    runs, over in-memory test chunks), SubMPSD_w128.json (half precision;
    a 1-epoch fit from seeded weights), SegQuantifier.json,
    SingleEndedZCNN.json, OPs3ns_SCNet.json, SingleWaveformTCN.json,
    SingleWaveformRNN.json (cuDNN's RNN in the program), SCNet3D.json and
    IoniClassifierGraph.json (``Trainer.export_model``), each from the
    checkpoint its evaluation or
    fit wrote, on its first test chunk: the program's custom-op nodes (K1
    in the four row-path configs, K2 in the two SubMPSD ones, none in the
    others); the program reloaded in one fresh
    process that imports torch and the port only (``RELOAD_SCRIPT``) and
    run on the card, its output within EXPORT_TOL of a fresh Trainer's
    eager forward over the same batch and its K1 and K2 launches equal to
    that forward's (counts set to 0 just before and read just after each).
    Then ``torch.library.opcheck`` of the five ops on the card and the
    dispatch timing. Returns the dispatch timing."""
    from waveformml_tpu_torch import evaluate
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule

    fit = make_trainer(load_config(CONFIG_W128), w128_state(load_config(CONFIG_W128)),
                       plain=False, max_epochs=1,
                       checkpoint_dir=os.path.join(work_dir, "SubMPSD_w128.json", "version_0"))
    fit.fit(BlockDataModule(half_blocks(train[:2]), half_blocks(val)))
    checkpoints = dict(checkpoints)
    checkpoints[CONFIG_W128] = (fit.best_ckpt_path, half_blocks(checkpoints[CONFIG][1][:1]))
    expected = {CONFIG: ("subm_conv_rows", "site_grouped_matmul"),
                CONFIG_W128: ("subm_conv_rows", "site_grouped_matmul"),
                CONFIG_SEGQ: ("subm_conv_rows",), CONFIG_Z: (),
                CONFIG_OPS: ("subm_conv_rows",), CONFIGS_WAVEFORM[0]: (),
                CONFIGS_WAVEFORM[1]: (), CONFIG_3D: (), CONFIG_GRAPH: ()}
    cases = []
    for cfg_path, kernels in expected.items():
        ckpt, test = checkpoints[cfg_path]
        tag = os.path.basename(cfg_path)
        t0 = time.perf_counter()
        if cfg_path == CONFIG:
            args = evaluate.build_parser().parse_args([cfg_path, ckpt, "--script",
                                                       "--limit_test_batches", "1"])
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                path = evaluate.run(load_config(cfg_path), args,
                                    BlockDataModule([], [], test))["exported"]
            assert path == os.path.join(evaluate.log_dir_for(ckpt), "model.pt2"), path
            how = (f"evaluate.run with --script (python -m waveformml_tpu_torch.evaluate's run, "
                   f"over in-memory test chunks: no h5py here; it printed "
                   f"{printed.getvalue().strip()!r})")
        else:
            path = loaded_trainer(cfg_path, ckpt).export_model(
                os.path.join(os.path.dirname(ckpt), "model.pt2"), test[0])
            how = "Trainer.export_model"
        export_s = time.perf_counter() - t0
        ops = exported_ops(path)
        print(f"export {tag}: {how} wrote {path} ({os.path.getsize(path)} bytes) in "
              f"{export_s:.2f} s; custom-op nodes of its graph {ops}", flush=True)
        assert {k.split(".")[1] for k in ops} == set(kernels), (tag, ops)
        # a fresh Trainer: the site capacity of the batch the export traced
        trainer = loaded_trainer(cfg_path, ckpt)
        db = trainer.device_batch(test[0])[0]
        zero_counts()
        eager = trainer.task.apply_model(db)
        torch.cuda.synchronize()
        launches = read_counts()
        for k in kernels:
            assert launches[k] > 0, (tag, launches)
        base = os.path.dirname(path)
        torch.save({k: v.cpu() for k, v in db.items()}, os.path.join(base, "batch.pt"))
        cases.append(dict(tag=tag, path=path, batch=os.path.join(base, "batch.pt"),
                          out=os.path.join(base, "reloaded.pt"), eager=eager.cpu(),
                          launches={k: launches[k] for k in ("subm_conv_rows",
                                                             "site_grouped_matmul")}))

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    argv = [sys.executable, "-c", RELOAD_SCRIPT]
    for c in cases:
        argv += [c["path"], c["batch"], c["out"]]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"reloading the exported programs failed:\n{proc.stderr}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == len(cases), proc.stdout
    print(f"export: {len(cases)} programs reloaded and run in one fresh process in "
          f"{time.perf_counter() - t0:.2f} s (wall, its start included)", flush=True)
    for c, line in zip(cases, lines):
        print(f"export {c['tag']} reloaded: {json.dumps(line)}", flush=True)
        assert line["program"] == c["path"] and line["finite"] and not line["foreign_modules"]
        got = torch.load(c["out"])
        torch.testing.assert_close(got, c["eager"], rtol=EXPORT_TOL, atol=EXPORT_TOL)
        assert line["launches"] == c["launches"], (c["tag"], line["launches"], c["launches"])
        print(f"export {c['tag']}: the reloaded program's output matches the eager forward "
              f"(rtol=atol={EXPORT_TOL}; largest |difference| "
              f"{float((got - c['eager']).abs().max()):.3g}); its K1/K2 launches "
              f"{line['launches']} equal one eager forward's", flush=True)

    trainer = loaded_trainer(CONFIG, checkpoints[CONFIG][0])
    check_ops_on_card(trainer, trainer.device_batch(checkpoints[CONFIG][1][0])[0])
    return run_dispatch_timing(CONFIG, state, train, card)


def run_analyze(chunks, n_samples: int) -> int:
    """``analyze_records`` (scripts/analyze_waveforms.py) over the serving
    chunks' waveform pairs on the card, every kernel's count set to 0 just
    before and read just after (K3 once a chunk), and on the CPU: the
    average waveforms equal, each feature mean within the mean of K3's
    per-row tolerance (``features_limits``) over those rows. Returns K3's
    launches."""
    from waveformml_tpu_torch.ops.waveform_features import (features_limits,
                                                            waveform_features_plain)
    from waveformml_tpu_torch.scripts.analyze_waveforms import analyze_records

    records = [ch["waveforms"] for ch in chunks]
    zero_counts()
    t0 = time.perf_counter()
    card = analyze_records(records, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    assert launches == dict(dict.fromkeys(launches, 0), waveform_features=len(records)), launches
    t0 = time.perf_counter()
    cpu = analyze_records(records, "cpu")
    cpu_wall = time.perf_counter() - t0
    assert card["n"] == cpu["n"] == sum(r.shape[0] for r in records)
    assert np.array_equal(card["mean"], cpu["mean"]) and np.array_equal(card["err"], cpu["err"])
    halves = torch.from_numpy(np.concatenate([r[:, :n_samples] for r in records]))
    limits = features_limits(waveform_features_plain(halves), halves, TOL["waveform_features"])
    diffs = {}
    for (k, v), limit in zip(cpu["features"].items(), limits):
        diffs[k] = abs(card["features"][k] - v)
        assert diffs[k] <= float(limit.mean()), (k, card["features"][k], v, float(limit.mean()))
    print(f"analyze_records: {card['n']} waveform pairs in {len(records)} chunks in "
          f"{wall:.4f} s on the card (CPU {cpu_wall:.4f} s); launches {launches}; feature "
          f"means {({k: round(v, 6) for k, v in card['features'].items()})}, |card - CPU| "
          f"{({k: float(f'{v:.3g}') for k, v in diffs.items()})}, each within the mean of "
          f"K3's per-row tolerance; average waveforms equal", flush=True)
    return launches["waveform_features"]


def seeded_submpsd(cfg):
    """SubMPSD.json's net from seeded random weights, its head's bias too
    (initialisation leaves it zero, which K2 adds)."""
    from waveformml_tpu_torch.models.nets import SubMPSDNet

    gen = torch.Generator().manual_seed(SEED)
    model = SubMPSDNet(cfg, generator=gen)
    with torch.no_grad():
        model.head0.bias.normal_(generator=gen)
    return model


def dp_main(n: int, gloo: bool = False, tp: int = 1) -> int:
    """``python3 chip_smoke.py --dp-ranks N [--tp T] [--gloo]``: the
    data-parallel ranks of phase 8c (b) alone (``run_dp_ranks``), or with
    ``--tp T`` the tensor-parallel ranks of phase 8d on an (N / T, T) grid,
    one a card over NCCL, N cards needed, or with ``--gloo`` all N on card
    0 over Gloo, as the phases run them; the same last line as ``main``."""
    cards_needed = 1 if gloo else n
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards_needed:
        print(f"chip_smoke --dp-ranks {n}: needs {cards_needed} CUDA card(s)", file=sys.stderr)
        return 1
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import labelled_block
    from waveformml_tpu_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout
    print(cards.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    reports = native.build()
    print(f"build: nvcc {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = load_config(CONFIG)
    state = seeded_submpsd(cfg).state_dict()
    train_rng = np.random.default_rng(SEED + 4)
    n_samples = cfg.system_config.n_samples
    train = [labelled_block(train_rng, EVENTS_PER_CHUNK, n_samples)
             for _ in range(TRAIN_CHUNKS)]
    val = [labelled_block(train_rng, EVENTS_PER_CHUNK, n_samples) for _ in range(VAL_CHUNKS)]
    tag = f"--dp-ranks {n}" + (f" --tp {tp}" if tp > 1 else "")
    if gloo:
        run_dp_ranks(cfg, state, train, val, ["cuda:0"] * n, "gloo", f"{tag} --gloo", tp=tp)
    else:
        run_dp_ranks(cfg, state, train, val, [f"cuda:{r}" for r in range(n)], "nccl", tag,
                     tp=tp)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.datasets.synthetic import (BlockDataModule, labelled_block,
                                                         make_events, synth_waveform_pair)
    from waveformml_tpu_torch.detector import MAX_RANGE
    from waveformml_tpu_torch.engineering.base import pack_db
    from waveformml_tpu_torch.inference.model import InferenceModel
    from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops import native
    from waveformml_tpu_torch.ops.row_conv import k1_grids
    from waveformml_tpu_torch.ops.site_head import site_grouped_matmul
    from waveformml_tpu_torch.ops.waveform_features import waveform_features

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = [time.perf_counter()] * 2

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"time: {what} took {now - started[1]:.1f} s ({now - started[0]:.1f} s since "
              f"the start)", flush=True)
        started[1] = now

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = native.build()
    print(f"build: nvcc {sorted(reports) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # -- data and model -------------------------------------------------------
    cfg = load_config(CONFIG)
    n_samples = cfg.system_config.n_samples
    rng = np.random.default_rng(SEED)
    chunks = [make_events(rng, EVENTS_PER_CHUNK, n_samples, kind=i % 2)
              for i in range(N_CHUNKS)]
    inputs = [(ch["coords"], (ch["waveforms"] / MAX_RANGE).astype(np.float32))
              for ch in chunks]
    model = seeded_submpsd(cfg)
    state = model.state_dict()
    server = InferenceModel(cfg, state)
    t0 = time.perf_counter()
    server(*inputs[0])                       # loads the kernels' libraries
    torch.cuda.synchronize()
    print(f"first chunk (library load, allocator warm-up, capture of its layout): "
          f"{time.perf_counter() - t0:.3f} s, {len(server.graphs)} graph(s)", flush=True)

    # -- 3. kernels against their plain versions ------------------------------
    probe = torch.zeros(16, device="cuda")
    print(f"timing floor: a graph of one 16-float add replays in "
          f"{graph_time_ms(lambda: probe.add_(1)):.5f} ms; in a graph of {RUN_CALLS} "
          f"such adds, each takes {graph_time_ms(lambda: probe.add_(1), RUN_CALLS):.5f} ms",
          flush=True)
    coords0, feats0 = inputs[0]
    task = server.task
    block = FileBlock(coords0, feats0, np.zeros(EVENTS_PER_CHUNK, np.int64))
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    wfs_main = torch.from_numpy(np.concatenate(
        [ch["waveforms"][:, :n_samples] for ch in chunks])).cuda()
    wfs_150 = torch.from_numpy(np.stack(
        [synth_waveform_pair(rng, 150, rng.uniform(0.5, 10.0), 0.0)[:150]
         for _ in range(4097)])).cuda()
    wfs_pairs = torch.from_numpy(np.concatenate([ch["waveforms"] for ch in chunks])).cuda()
    results = {
        "subm_conv_rows": check_subm_conv_rows(task.model, db, db["feats"]),
        "site_grouped_matmul": check_site_grouped_matmul(task.model, db),
        "waveform_features": check_waveform_features(wfs_main, wfs_150, wfs_pairs, rng),
    }
    results["subm_conv_rows"]["max_abs_err"] = max(
        results["subm_conv_rows"]["max_abs_err"], check_subm_conv_rows_adversarial(rng))
    head = task.model.head0
    results["site_grouped_matmul"]["max_abs_err"] = max(
        results["site_grouped_matmul"]["max_abs_err"],
        check_site_grouped_matmul_adversarial(rng, head.cin, head.features))
    results["subm_conv_rows_wgrad"], d_feats_err = check_subm_conv_rows_wgrad(task.model, db,
                                                                              db["feats"])
    results["subm_conv_rows"]["max_abs_err"] = max(results["subm_conv_rows"]["max_abs_err"],
                                                   d_feats_err)
    results["subm_conv_rows_wgrad"]["max_abs_err"] = max(
        results["subm_conv_rows_wgrad"]["max_abs_err"],
        check_subm_conv_rows_wgrad_adversarial(rng))
    results["site_grouped_matmul_bwd"] = check_site_grouped_matmul_bwd(task.model, db)
    results["site_grouped_matmul_bwd"]["max_abs_err"] = max(
        results["site_grouped_matmul_bwd"]["max_abs_err"],
        check_site_grouped_matmul_bwd_adversarial(rng, head.cin, head.features))

    # -- 4. serving path: one CUDA graph per batch layout ---------------------
    server.dispatch_phases = dict.fromkeys(server.dispatch_phases, 0.0)
    server.capture_s = 0.0
    graphs_before = len(server.graphs)
    for g in server.graphs.values():
        g.replays = 0
    zero_counts()
    t0 = time.perf_counter()
    handles = [server.dispatch(c, f) for c, f in inputs]
    logits = [server.fetch(h) for h in handles]
    wall = time.perf_counter() - t0
    replayed = server.replay_launches()
    eager = read_counts()
    launches = {name: eager[name] + replayed[name] for name in eager}
    new_graphs = len(server.graphs) - graphs_before
    replays = sum(g.replays for g in server.graphs.values())
    n_events = N_CHUNKS * EVENTS_PER_CHUNK
    n_rows = sum(c.shape[0] for c, _ in inputs)
    print(f"serving: {N_CHUNKS} chunks, {n_events} events, {n_rows} waveform pairs "
          f"in {wall:.4f} s = {n_events / wall:.1f} events/s; graphs {len(server.graphs)} "
          f"({new_graphs} captured in this run), {replays} replays; launches {launches}, "
          f"of which from replays {replayed}", flush=True)
    # K1: one grid per conv for the centre tap, one more for a K² > 1 conv's
    # other taps (the tiles design, every 9-tap conv); K2: one grid writes
    # the head's bias into the event rows, one adds the slots' products.
    # Each chunk is one replay; a layout new in this run also ran once
    # eagerly before its capture.
    per_chunk = dict.fromkeys(launches, 0)
    per_chunk.update(subm_conv_rows=sum(k1_grids(*m.weight.shape)
                                        for m in task.model.stack.modules()
                                        if isinstance(m, RowSubMConv2d)),
                     site_grouped_matmul=2)
    assert replays == N_CHUNKS, replays
    assert replayed == {k: v * N_CHUNKS for k, v in per_chunk.items()}, replayed
    assert eager == {k: v * new_graphs for k, v in per_chunk.items()}, eager
    for out in logits:
        assert out.shape == (EVENTS_PER_CHUNK, cfg.system_config.n_type), out.shape
        assert np.isfinite(out).all()
    # where the serving time goes: the host-clock phases of that run, and
    # the device forward of one chunk as a CUDA-graph replay
    forward_ms = graph_time_ms(lambda: task.apply_model(db))
    names = {"host_prep_s": "host prep (pad, plans, pack)", "h2d_s": "copy in",
             "launch_s": "replay + copy out", "fetch_s": "fetch"}
    phases = "; ".join(f"{names[k]} {v * 1e3 / N_CHUNKS:.3f} ({v / wall:.1%})"
                       for k, v in server.dispatch_phases.items())
    packed = [sum(leaf[4] for leaf in spec) for spec in server.graphs]
    # host prep split: prepare_block (pad, plans) and the pack into pinned
    # memory, medians of 10 of each on the first chunk
    prep_t, pack_t = [], []
    blk = FileBlock(coords0, feats0, np.zeros(EVENTS_PER_CHUNK, np.int64))
    for _ in range(10):
        t1 = time.perf_counter()
        db_host = task.prepare_block(blk, task.row_bucket(blk), task.event_bucket(blk))
        t2 = time.perf_counter()
        pack_db(db_host, pin_memory=True)
        pack_t.append(time.perf_counter() - t2)
        prep_t.append(t2 - t1)
    print(f"serving host prep of one chunk: prepare_block {statistics.median(prep_t) * 1e3:.3f} "
          f"ms, pack into pinned memory {statistics.median(pack_t) * 1e3:.3f} ms (medians of "
          f"10)", flush=True)
    print(f"serving breakdown (ms/chunk, share of wall): {phases}; capture of new layouts "
          f"{server.capture_s * 1e3:.3f} ms in all; device forward {forward_ms:.4f}; wall "
          f"{wall * 1e3 / N_CHUNKS:.3f}; device busy share "
          f"{N_CHUNKS * forward_ms / (wall * 1e3):.4f}; {n_events / wall:.1f} events/s; "
          f"packed chunk bytes {packed}", flush=True)

    # the graph path against the eager forward with the kernels and the
    # graph path with the plain versions, on the card
    reference = InferenceModel(cfg, state)
    for module in reference.task.model.modules():
        if isinstance(module, (RowSubMConv2d, FoldedSiteLinear)):
            module.plain = True
    agree, err_eager = 0, 0.0
    for (c, f), out in zip(inputs, logits):
        want = reference(c, f)
        np.testing.assert_allclose(out, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        agree += int((out.argmax(-1) == want.argmax(-1)).sum())
        blk = FileBlock(c, f, np.zeros(EVENTS_PER_CHUNK, np.int64))
        direct = task.apply_model(task.to_device(task.prepare_block(
            blk, task.row_bucket(blk), task.event_bucket(blk))))[:EVENTS_PER_CHUNK]
        direct = direct.cpu().numpy()
        np.testing.assert_allclose(out, direct, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        err_eager = max(err_eager, float(np.abs(out - direct).max()))
    small = coords0[:, -1] < 64
    cpu = InferenceModel(cfg, state, device="cpu")(coords0[small], feats0[small])
    card_small = server(coords0[small], feats0[small])
    np.testing.assert_allclose(card_small, cpu, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(card_small, logits[0][:64], rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    print(f"logits of the graph path match the eager forward (largest |difference| "
          f"{err_eager:.3g}) and the plain versions on the card (rtol={LOGIT_RTOL}, "
          f"atol={LOGIT_ATOL}); argmax agrees on {agree}/{n_events} events; 64 events "
          f"match the CPU run", flush=True)

    # int16 ADC counts scaled on the card (preprocess), log-probabilities
    # taken on the card (postprocess), against float32 features scaled on
    # the host through the float32 server
    adc = [np.rint(ch["waveforms"]).astype(np.int16) for ch in chunks]
    server16 = InferenceModel(
        cfg, state, preprocess=lambda c, f, m: f.float() / MAX_RANGE,
        postprocess=lambda out, c, m: torch.log_softmax(out, dim=-1))
    err16 = 0.0
    for (c, _), raw in zip(inputs, adc):
        got = server16(c, raw)
        want = torch.log_softmax(torch.from_numpy(
            server(c, raw / np.float32(MAX_RANGE))), dim=-1).numpy()
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        err16 = max(err16, float(np.abs(got - want).max()))
    packed16 = [sum(leaf[4] for leaf in spec) for spec in server16.graphs]
    print(f"int16 preprocess + log-softmax postprocess on the card: {N_CHUNKS} chunks match "
          f"the float32 path (largest |difference| {err16:.3g}); packed chunk bytes "
          f"{packed16} against {packed}", flush=True)

    # double-buffered: chunk i+1 dispatched before chunk i is fetched
    sync = [server(c, f) for c, f in inputs]
    streamed, pending = [], server.dispatch(*inputs[0])
    for c, f in inputs[1:]:
        nxt = server.dispatch(c, f)
        streamed.append(server.fetch(pending))
        pending = nxt
    streamed.append(server.fetch(pending))
    err_stream = 0.0
    for got, want in zip(streamed, sync):
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        err_stream = max(err_stream, float(np.abs(got - want).max()))
    print(f"double-buffered dispatch/fetch matches synchronous calls (largest |difference| "
          f"{err_stream:.3g}: K1's atomics vary the last bits between runs); graphs "
          f"{len(server.graphs)}, replays {sum(g.replays for g in server.graphs.values())} "
          f"since the serving run's start", flush=True)

    # -- 5. waveform-features path --------------------------------------------
    waveform_features.launches = 0
    t0 = time.perf_counter()
    arrival, psd, total, peak = waveform_features(wfs_main)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["waveform_features"] = waveform_features.launches
    assert launches["waveform_features"] == 1, launches
    for x in (arrival, psd, total, peak):
        assert x.shape == (wfs_main.shape[0],) and bool(torch.isfinite(x).all())
    assert bool(((psd >= 0) & (psd <= 1)).all())
    print(f"waveform features: {wfs_main.shape[0]} waveforms x {n_samples} samples "
          f"in {wall:.4f} s; means arrival={float(arrival.mean()):.4f} "
          f"psd={float(psd.mean()):.4f} total={float(total.mean()):.1f} "
          f"peak={float(peak.mean()):.1f}", flush=True)

    lap("build, kernel checks, serving and K3 (phases 2-5)")

    # -- 6. training path -----------------------------------------------------
    train_rng = np.random.default_rng(SEED + 4)
    train = [labelled_block(train_rng, EVENTS_PER_CHUNK, n_samples)
             for _ in range(TRAIN_CHUNKS)]
    val = [labelled_block(train_rng, EVENTS_PER_CHUNK, n_samples) for _ in range(VAL_CHUNKS)]
    train_launches = run_training(cfg, state, train, val)
    # the Trainer's arguments, over an odd number of blocks an epoch
    run_training_flags(cfg, state, train + [labelled_block(train_rng, EVENTS_PER_CHUNK,
                                                           n_samples)], val)
    # the JSON line reports each kernel's launches on the training path where
    # it runs there; K3's are replaced by those of its user path below
    launches = {name: train_launches[name] or launches.get(name, 0) for name in train_launches}

    lap("training (phase 6)")

    # -- 7. SubMPSD_w128.json in half precision -------------------------------
    run_w128(chunks, train, val)
    lap("SubMPSD_w128.json (phase 7)")

    # -- 8. the CLI -----------------------------------------------------------
    run_cli(CONFIG, train, val, ("train_loss", "train_accuracy", "val_loss", "val_accuracy"),
            ("test_loss", "test_accuracy"),
            ("subm_conv_rows", "site_grouped_matmul", "subm_conv_rows_wgrad",
             "site_grouped_matmul_bwd"))

    lap("the CLI (phase 8)")

    # -- 8b. the profiler and the hyperparameter study ----------------------------
    run_profiler(cfg, state, train, val)
    run_hpo(model, train, val)
    print("combine_data and scripts/validate_combined.py: host tools over HDF5 files (they "
          "need h5py); this script does not run them, "
          "tests/test_torch_combine.py holds them to the JAX package's on the CPU", flush=True)
    lap("the profiler and the hyperparameter study (phase 8b)")

    # -- 8c. data-parallel training -------------------------------------------------
    run_dp_nccl(cfg, train, val)
    dp_ref = dp_reference(cfg, state, train, val)
    run_dp_ranks(cfg, state, train, val, DP_DEVICES, "gloo", "8c (b)", ref=dp_ref)
    lap("data-parallel training (phase 8c)")

    # -- 8d. tensor-parallel training ------------------------------------------------
    tp_results, tp_launches = run_tp(cfg, state, train, val, dp_ref, task.model, db)
    lap("tensor-parallel training (phase 8d)")

    # -- 9. the per-segment regressors -----------------------------------------
    z_train, z_val = run_z()
    segq, segq_launches = run_segq()
    run_cli(CONFIG_Z, z_train, z_val, ("train_loss", "val_loss"), ("test_loss",), (),
            hdf5_dirs=False)

    lap("the per-segment regressors and their CLI (phase 9)")

    # -- 10. the sparse event classifiers ----------------------------------------
    ops, ops_launches, ops_state, ops_train, ops_val = run_sparse_nets()
    run_validate_cli(ops_train, ops_val)
    lap("the sparse event classifiers and main --validate (phase 10)")

    # -- 11. the waveform nets and the 3D net -------------------------------------
    waveform = run_waveform_nets()
    rows3d, rows3d_launches, d3_state, d3_train, d3_val = run_scnet3d()
    lap("the waveform nets and SCNet3D.json (phase 11)")

    # -- 11b. the graph family ---------------------------------------------------
    graph_state, graph_train, graph_val = run_graph()
    lap("the graph family (phase 11b)")

    # -- 12. the prediction writers --------------------------------------------
    run_writers()
    lap("the prediction writers (phase 12)")

    with tempfile.TemporaryDirectory() as work_dir:
        # -- 13. the evaluation ------------------------------------------------
        _, checkpoints = run_evaluation(state, train, val, work_dir, waveform)
        graph_test = [labelled_block(np.random.default_rng(SEED + 165), EVENTS_PER_CHUNK,
                                     load_config(CONFIG_GRAPH).system_config.n_samples,
                                     max_mult=GRAPH_MAX_MULT)]
        _, ckpt = run_evaluate("IoniClassifierGraph.json", CONFIG_GRAPH, graph_state,
                               graph_train[:2], graph_val, graph_test, "logits",
                               work_dir=work_dir)
        checkpoints[CONFIG_GRAPH] = (ckpt, graph_test)
        for path, (st, tr, va) in ((CONFIG_OPS, (ops_state, ops_train, ops_val)),
                                   (CONFIGS_WAVEFORM[1], waveform[CONFIGS_WAVEFORM[1]]),
                                   (CONFIG_3D, (d3_state, d3_train, d3_val))):
            fit = make_trainer(load_config(path), st, plain=False, max_epochs=1,
                               checkpoint_dir=os.path.join(work_dir, os.path.basename(path),
                                                           "version_0"))
            fit.fit(BlockDataModule(tr[:2], va))
            checkpoints[path] = (fit.best_ckpt_path, va)

        lap("the evaluation (phase 13)")

        # -- 14. the export ----------------------------------------------------
        run_export(checkpoints, state, train, val, work_dir, card)
        lap("the export (phase 14)")

    # -- 15. the waveform analysis, K3's user path ------------------------------
    launches["waveform_features"] = run_analyze(chunks, n_samples)
    lap("the waveform analysis (phase 15)")

    # -- 16. report -----------------------------------------------------------
    sources = {
        "subm_conv_rows": ("cuda", "waveformml_tpu_torch/csrc/row_conv.cu",
                           "waveformml_tpu/ops/row_conv.py:226"),
        "site_grouped_matmul": ("cuda", "waveformml_tpu_torch/csrc/site_head.cu",
                                "waveformml_tpu/ops/site_head.py:83"),
        "waveform_features": ("cuda", "waveformml_tpu_torch/csrc/waveform_features.cu",
                              "waveformml_tpu/ops/pallas_dsp.py:113"),
        "subm_conv_rows_wgrad": ("cuda", "waveformml_tpu_torch/csrc/row_conv_wgrad.cu",
                                 "waveformml_tpu/ops/row_conv.py:257"),
        "site_grouped_matmul_bwd": ("cuda", "waveformml_tpu_torch/csrc/site_head_bwd.cu",
                                    "waveformml_tpu/ops/site_head.py:96"),
    }
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K1 and K4 again at SegQuantifier.json's and OPs3ns_SCNet.json's widths
    # and at 27 taps (SCNet3D.json's section in row space), each launched by
    # its own path
    for config, numbers, counts in (("SegQuantifier.json", segq, segq_launches),
                                    ("OPs3ns_SCNet.json", ops, ops_launches),
                                    ("SCNet3D.json rows, 27 taps", rows3d, rows3d_launches)):
        for name in ("subm_conv_rows", "subm_conv_rows_wgrad"):
            route, source, replaces = sources[name]
            r = numbers[name]
            kernels.append({"name": f"{name} ({config})", "route": route,
                            "source": source, "replaces": replaces,
                            "launches": counts[name], "max_abs_err": r["max_abs_err"],
                            "ms": r["ms"], "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                            "library_ms": r["library_ms"]})
    # K1, K4, K2 and K5 at the column blocks' widths, launched by phase 8d's
    # (2, 2) rank 0
    for name, label in (("subm_conv_rows", "tp=2: Cout 52 and 28"),
                        ("subm_conv_rows_wgrad", "tp=2: Cout 52 and 28"),
                        ("site_grouped_matmul", "tp=2: (C, F) = (8, 25)"),
                        ("site_grouped_matmul_bwd", "tp=2: (C, F) = (8, 25)")):
        route, source, replaces = sources[name]
        r = tp_results[name]
        kernels.append({"name": f"{name} ({label})", "route": route, "source": source,
                        "replaces": replaces, "launches": tp_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tap-designs"]:
        sys.exit(tap_designs_main())
    if sys.argv[1:2] == ["--ab-k1"]:
        sys.exit(ab_k1_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-ranks"]:
        flags = sys.argv[3:]
        sys.exit(dp_main(int(sys.argv[2]), "--gloo" in flags,
                         int(flags[flags.index("--tp") + 1]) if "--tp" in flags else 1))
    sys.exit(main())
