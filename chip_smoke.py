"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from `sparse_coding__tpu_torch/ops/csrc`
(one nvcc per source, all at once), holds each against its plain PyTorch
version at its path's shapes and times it, then drives four paths through
`ensemble_train_loop` over a synthetic chunk store, each with the launch
counts set to 0 just before it and read just after:
  - the tied-SAE L1-sweep (8 members, 512 -> 4096, batch 2048, Adam lr 1e-3
    with bf16 mu, bf16 compute): K1 + K2 every step, K1 + K3 on a masked step;
  - the same at the capacity setting (int8 mu, bf16 nu, SC_RECOMPUTE_CODE=1,
    an int8-tier chunk store): K1n + K2 (rebuilding the code) every step,
    K1 + K3 on a masked step;
  - the TopK k-sweep of BASELINE config 4 (7 members k 1..151, 768 -> 12288,
    batch 2048, Adam lr 1e-3 with f32 moments, bf16 compute): K_s + K_d + K2
    every step, K_s + K_d + K3 on a masked step, K2 and K3 on their sparse
    route (only the code's non-zeros touched; the tied paths keep the dense
    route);
  - the same at the capacity setting (16 steps): the sparse K2 with int8 mu,
    bf16 nu;
  - the FISTA dictionary path of BASELINE config 3 (4 members l1 1e-4..3e-3,
    512 -> 2048, batch 2048, Adam lr 1e-3, 500 FISTA iterations, 8 steps):
    the autograd gradient step, then the decoder update's solve on K_f every
    step, K_f on a masked step;
and evaluates and exports each path's dictionaries, and times one resident
step of each with its peak device memory, eager (`Ensemble.step_batch`) and
as replays of its captured CUDA graph (`Ensemble.step_scan`, the route
`ensemble_train_loop` takes). On the four fused paths at full width, 8 graph
steps are held bit for bit to 8 eager steps from a cloned state (losses,
params, moments, count, step) and must launch the same kernels as often.
Then the health pack and the feature sketch on the tied path at full width
(they turn the fused kernels off, as in JAX): 8 replays of the captured
autograd step with the packs against 8 eager steps, bit for bit, and a twin
without the packs whose losses and codes they leave unchanged; then the
FISTA driver (`train/basic_l1_sweep.py`) at BASELINE config 1 (8 members,
512 -> 2048, batch 1024, 500 iterations, health and feature stats on) over a
store of 2 chunks of 4,096 rows, 2 epochs: K_f every step, no plain solve,
exports, feature snapshots and health metrics checked; then the same run
SIGTERMed after epoch 1's first chunk in a process of its own and resumed
in another (``chip_smoke.py --bls-worker``), its exports, firing EMA and
snapshots the uninterrupted run's bits; then the fleet scheduler over that
driver (`fleet`, ROADMAP A9's fleet group): the 8 members packed into 2
items of 4 from that run's device-memory watermark, two worker processes on
the card (``chip_smoke.py --fleet-worker``, the port's worker CLI) under
a 6 s lease, w0 with a torn checkpoint, a transient chunk read and a SIGKILL
after its second item's ``ckpt_0``, this process ticking the scheduler that
reaps the dead lease so the other worker resumes the item: 8 members done,
0 lost, each group's export the bits of an uninterrupted control run, a run
dir served by the registry and the runs pushed to a local "remote" and
pulled back through `utils.sync`. Then the sweep driver
(`train/sweep.py::sweep`) at BASELINE config 2's widths over a
`SparseMixDataset` store of 3 chunks of 65,536 rows: ensemble A (the tied
path's 8 members, Adam) launches K1 + K2 every step, ensemble B (4 members,
a warmup learning-rate schedule) K1 + K3; then the same sweep preempted by
SIGTERM at position 1 in a process of its own (exit 75) and resumed in
another, whose final export must equal the uninterrupted run's bit for bit
(``chip_smoke.py --sweep-worker`` is that process's entry). Then the
experiment catalog (`train/experiments.py`): its kernels at the shapes it
gives them (K1/K2 at M 32, N 256; K_s/K_d/the sparse K2 at M 16, N 256,
k 1..151), then `run_sweep_synthetic` at width 512 with three builders in
bf16 over one store (`synthetic_linear_range`, `tied_vs_not_experiment`,
`topk_experiment`) and the default builder in exact f32, then the four
ablation builders (LISTA, thresholding, the 96-member masked dict-ratio
stack also in bf16, positive) in f32, each ensemble's launches counted and
none outside the train loops (the ablations launch none), the export, the
evaluation, the matched MCS and the streaming moments checked; then the
signatures no builder trains (`signatures`: tied-centred, masked, reverse,
residual-denoising, semi-linear, RICA, DirectCoef at D 512, N 2048, 8
members): graph steps bit-equal to eager ones, the card's steps to the
CPU's at a small shape, and `calc_pca` of a 65,536-row chunk against
float64 with its whitening. Then the
subject LM and the activation harvest (`lm/`, `data/activations.py`) at
Pythia-70M's full width: a seeded random init pretrained on the trigram
language for 300 steps (the loss must fall by a nat), layer 2's residual
and MLP output harvested in one pass into 3 chunks of 65,536 rows,
`harvest_to_device` held to the disk store bit for bit and a bf16-compute
chunk to the f32 one; the same harvest SIGKILLed in chunk 1's pair gap in a
process of its own (``chip_smoke.py --harvest-worker``) and resumed in
another, bit for bit; then `run_single_layer` (16 tied members, ratio 8,
bf16) on the harvested residual store: K1 and K2 96 times each, nothing
else, every member's FVU on held-out rows below 1; K1/K2 at that shape are
the kernels line's ``harvest_sweep`` rows. Then serving (`serve/`) of that
sweep's export, 16 dicts of 4096 x 512: the encode engine native and
int8-resident, its dispatch menu (buckets 8..1024, dense and top-k 32)
captured as CUDA graphs, every lane equal to its stack of one and every
replay to its eager dispatch at every bucket, no capture under 200 random
requests (`serve_encode`, no hand-written kernel launched); the HTTP server
with the pretrained subject on ``/features`` (held to harvest-then-encode)
under 16 closed-loop clients (`serve_http`); and the server as a process of
its own (``chip_smoke.py --serve-worker``) SIGTERMed under that load, every
response bit-correct or a retryable 503 (`serve_drain`); then the replicated
tier (`serve_tier`): ``python -m sparse_coding__tpu_torch.serve.replicaset``
with 2 replica processes on the card behind its router, under 8 closed-loop
`RouterClient` threads, one replica SIGKILLed and relaunched, then a second
generation of the export (each dict's rows rolled by one) rolled out through
the swap file, then the tier SIGTERMed: every response bit-equal to the stack
of one of its declared generation at its bucket, none dropped, none torn.
Before serving, the paper's evaluation (`metrics/intervention.py`,
`interp/`, `train/toy_models.py`) on the pretrained subject and the sweep's
16 dicts (`evaluate_lm`): the loss under each dict's reconstruction over 64
held-out sequences (identity = base loss, vmapped = per-dict bits, card vs
CPU on one batch), `cache_all_activations` = `run_with_cache` + encode, and
both ablation graphs (32 features; 4 positions x 8 features), each one
captured CUDA graph replayed per feature, equal to an eager per-feature
loop bit for bit; autointerp's activation frames for the 16 dicts over
256 fragments (`interp_codes`, each frame's activations its dict's own
capture + encode's bits; whether pandas and pyarrow import); and the superposition toy grid at
`ToyArgs`' widths (`toy_grid`, N 512..16384, batch 4096, 400 epochs) with
`run_single_go` card vs CPU from the same params and batches. None of the
three launches a hand-written kernel (JAX computes them in plain XLA).
After the toy grid, still before serving, the remaining single-card paths,
none of which reaches a Pallas call in JAX (0 launches each): the
long-context harvest on blockwise attention (`blockwise_harvest`: layer 2 at
seq 8192 against dense attention, then 2 sequences of 32,768 tokens
harvested into a store of 2 chunks), the big-batch trainer with dead-feature
resurrection (`big_batch`: RESURRECT_r04's hyperparameters at ratio 32 on
the harvested store, four resurrections, the device time of a step, a bf16
arm, a worker SIGTERMed at the step-200 resurrection boundary and resumed to
the same bits, card vs CPU at the tests' shape; ``chip_smoke.py
--big-batch-worker`` is that process's entry) and the paper's experiments'
device halves (`paper_experiments`: the PCA-perplexity sweep of 112 dicts,
the embedding cosines, investigate, a feature case study, the dict
comparisons; card vs CPU on small inputs).
Last, scale-out (`scaleout`) at BASELINE config 5's widths (D 1024, N
32768, 4 tied members, batch 2048, bf16): K1/K2 (the WMMA kernels at D
1024), K3 at the data axis' local batch and K_f at FISTA's, each against
its plain version; a world of one over NCCL in this process (the
unsharded bits); a world of two processes on the one card over gloo
(``chip_smoke.py --scaleout-worker``: the model, data and dict axes held
to the world of one, FISTA's sharded step, the sweep uninterrupted and with
one rank SIGTERMed: both checkpoint one cursor and exit 75); the preempted
sweep resumed here as a world of one. Before it, still on the pretrained
subject, the sequence-parallel harvest (ROADMAP A6b's second part; no
Pallas call in JAX, 0 launches): ring and Ulysses attention and layer 2's
capture at seq 8192 against dense in a world of one over NCCL
(`seqpar_world1`), then in a world of two processes on the one card over
gloo (``chip_smoke.py --seqpar-worker``, `seqpar_world2`), which also
harvests 2 sequences of 8192 tokens with each strategy, rank 0 the only
writer, held to the single-card harvest row for row. Last, host only, the
run tools (`runtools`: the goodput ledger, report, timeline trace, SLO,
monitor and skew windows) over the run dirs the smoke kept.
Launch counts are the wrappers' (`ops/_wrap.py::LaunchCounts`, kept on the
card, so graph replays count), each set to 0 just before a run and read
just after; a profiler trace of the run may not count more, and a trace
that counts fewer is printed as ``trace_short``. Prints one JSON line per
phase, the smoke's total seconds, then the `kernels` line, the
`nvidia-smi` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. Needs a CUDA device; never
falls back to the CPU. Imports nothing of JAX or of `sparse_coding__tpu`.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

M, D, N, B = 8, 512, 4096, 2048
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
L1_GRID = [10 ** (-4 + 0.25 * i) for i in range(M)]
# TopK k-sweep, BASELINE config 4 (GPT-2-small residual, 16x dictionary)
TOPK_KS = [1, 11, 31, 61, 91, 121, 151]
TM, TD, TN, TB = len(TOPK_KS), 768, 12288, 2048
# the two paths driven end to end: the ensemble to build, its synthetic data,
# the forward kernels of its fused step, and each member's bound on L0 (None:
# no bound)
TIED = dict(
    path="tied_l1_sweep", prefix="", sig="FunctionalTiedSAE", members=M, width=D, batch=B,
    hparams=[{"l1_alpha": a} for a in L1_GRID],
    build=dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, compute_dtype="bfloat16",
               activation_size=D, n_dict_components=N),
    data=dict(n_ground_truth_components=1024, feature_num_nonzero=8, feature_prob_decay=0.996, key=0),
    fwd_kernels=("tied_sae_fwd",), masked_fwd=("tied_sae_fwd",), l0_max=None,
    bwd_adam="tied_sae_bwd_adam", bwd_grads="tied_sae_bwd_grads",
    store_dtype="float16", rows_per_chunk=65536, env={},
)
TOPK = dict(
    path="topk_k_sweep", prefix="topk_", sig="TopKEncoderApprox", members=TM, width=TD, batch=TB,
    hparams=[{"sparsity": k} for k in TOPK_KS],
    build=dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16",
               d_activation=TD, n_features=TN, sparsity_cap=max(TOPK_KS)),
    data=dict(n_ground_truth_components=4096, feature_num_nonzero=32, feature_prob_decay=0.999, key=1),
    fwd_kernels=("topk_scores", "topk_decode"), masked_fwd=("topk_scores", "topk_decode"), l0_max=TOPK_KS,
    bwd_adam="tied_sae_bwd_adam_sparse", bwd_grads="tied_sae_bwd_grads_sparse",
    store_dtype="float16", rows_per_chunk=65536, env={},
)
# the capacity setting (README): int8 mu, bf16 nu, the code rebuilt in the
# backward (the TopK step accepts the flag and ignores it), data from an
# int8-tier chunk store; the masked step's fused grads store the code (K1)
CAPACITY_ADAM = {"learning_rate": LR, "mu_dtype": "int8", "nu_dtype": "bfloat16"}
TIED_CAPACITY = dict(
    TIED, path="tied_capacity", prefix="capacity_", build=dict(TIED["build"], optimizer_kwargs=CAPACITY_ADAM),
    fwd_kernels=("tied_sae_fwd_nocode",), store_dtype="int8", env={"SC_RECOMPUTE_CODE": "1"},
)
TOPK_CAPACITY = dict(
    TOPK, path="topk_capacity", prefix="topk_capacity_", build=dict(TOPK["build"], optimizer_kwargs=CAPACITY_ADAM),
    store_dtype="int8", rows_per_chunk=16384, env={"SC_RECOMPUTE_CODE": "1"},
)
# the FISTA dictionary path, BASELINE config 3 (PARITY_r05_fista.json's config:
# FunctionalFista, Pythia-70M width 512, ratio 4, 4-way l1 sweep, batch 2048,
# Adam lr 1e-3, bf16 compute, 500 FISTA iterations, tol 0)
FISTA_L1 = [1e-4, 3e-4, 1e-3, 3e-3]
FM, FD, FN, FB, FISTA_ITERS = len(FISTA_L1), 512, 2048, 2048, 500
FISTA = dict(
    path="fista_l1_sweep", prefix="fista_", sig="FunctionalFista", members=FM, width=FD, batch=FB,
    hparams=[{"l1_alpha": a} for a in FISTA_L1],
    build=dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16", activation_size=FD,
               n_dict_components=FN),
    data=dict(n_ground_truth_components=1024, feature_num_nonzero=8, feature_prob_decay=0.996, key=2),
    l0_max=None, store_dtype="float16", rows_per_chunk=8192, env={},
)
# the sweep driver at BASELINE config 2's widths: a SparseMixDataset store of
# 3 fp16 chunks of 65,536 rows (1024 components, 8 active, decay 0.996), one
# epoch; ensemble A is the tied path's (K1 + K2), ensemble B the same widths
# with 4 members and a warmup schedule, which cannot be fused into K2 (K1 + K3)
SWEEP = dict(chunks=3, chunk_size_gb=0.0625, members_b=4, warmup_steps=16)
# the FISTA driver basic_l1_sweep at BASELINE config 1's width (the JAX
# driver's defaults: FunctionalFista, width 512, ratio 4, l1 logspace(-4, -2,
# 8), batch 1024, Adam lr 1e-3, 500 iterations, tol 0, the health pack and the
# feature sketch on), over a store of 2 chunks of 4,096 rows built on the card
# (tied's data), 2 epochs: 16 steps, a checkpoint at every chunk
BLS_L1 = [10 ** (-4 + 2 * i / 7) for i in range(8)]
BLS = dict(members=len(BLS_L1), width=512, n_dict=2048, batch=1024, chunks=2, rows_per_chunk=4096, epochs=2)
# the experiment catalog through `run_sweep_synthetic` at its own widths
# (Pythia-70M's 512, 2048 ground-truth components, 100 active, decay 0.996,
# batch 1024), builders in turn over one store cut in depth to 2 chunks of
# 65,536 rows and one epoch (the driver's default: 10 chunks of 2 GB): three
# in bf16 compute (the config's ``dtype``; the route to the kernels), then
# the driver's default builder at its default precision (exact f32,
# autograd: no hand-written kernel); the TopK builder at recall 0.95
# (`TopKEncoderApprox`); then the four ablation builders (ROADMAP A8a) at
# the catalog's default exact f32 (autograd: LISTA's 16 x 3 layers at N
# 512, 16 thresholding SAEs at N 2048, the 96-member masked dict-ratio stack
# of N 2560, 16 positive SAEs at N 512), the dict-ratio stack also in bf16
# (the masked signature applies the policy; still autograd, no kernel)
EXPERIMENTS = dict(builders=(("synthetic_linear_range", "bfloat16"), ("tied_vs_not_experiment", "bfloat16"),
                             ("topk_experiment", "bfloat16"), ("synthetic_linear_range", "float32"),
                             ("residual_denoising_experiment", "float32"), ("thresholding_experiment", "float32"),
                             ("dict_ratio_experiment", "float32"), ("dict_ratio_experiment", "bfloat16"),
                             ("run_positive_experiment", "float32")),
                   width=512, batch=1024, chunks=2, rows_per_chunk=65536, epochs=1, topk_recall=0.95,
                   eval_rows=4096)
# the new shapes the catalog gives the kernels (M, B, N, D): a tied
# `synthetic_linear_range` stack at ratio 0.5, a TopK stack at ratio 0.5 with
# k 1..151 (cap 151 of N 256: the code ~59% dense)
EXP_TIED = (32, 1024, 256, 512)
EXP_TOPK = (16, 1024, 256, 512)
EXP_KS = list(range(1, 161, 10))
# the signatures no builder trains (ROADMAP A8a), at the catalog's width:
# D 512, N 2048, 8 members, batch 1024, Adam lr 1e-3, exact f32; graph
# replays against eager steps at that width, then the same steps at a small
# shape (D 64, N 256, 4 members, batch 256) on the card against the CPU;
# `calc_pca` of a 65,536-row chunk against float64 numpy
SIGNATURES = dict(width=512, n_dict=2048, members=8, batch=1024, steps=3, small=(64, 256, 4, 256),
                  pca_rows=65536, pca_seed=41)
# the subject LM and its activation harvest (ROADMAP A5), at Pythia-70M's
# full width (`lm.model.config_for`: NeoX, 6 layers, d 512, 8 heads, d_mlp
# 2048, vocab 50304, rotary 0.25), cut in depth only: pretrained from a
# seeded random init on the trigram language for 300 steps (bf16 compute,
# JAX's lr 3e-4 and batch 32, a corpus of 4096 x 128 tokens), then layer 2's
# residual and MLP output harvested from a held-out sample of 768 x 256
# tokens in one pass (batch 64, chunks of 65,536 rows = 4 batches, 3
# chunks), and `run_single_layer`'s `dense_l1_range_experiment` (16 tied
# members, l1 logspace(-4, -2, 16), ratio 8: N 4096, batch 2048) trained on
# the residual store for one epoch: 3 x 32 steps
SUBJECT = dict(model="pythia-70m", lang_seed=7, corpus=(4096, 128), corpus_seed=11, steps=300, batch=32, lr=3e-4)
HARVEST = dict(rows=768, seq=256, seed=13, layer=2, locs=("residual", "mlpout"), batch=64, chunk_size_gb=0.0625,
               chunks=3, heldout_rows=64, heldout_seed=17, ratio=8, sweep_batch=2048)
HARVEST_TIED = (16, 2048, 4096, 512)  # K1/K2 at the harvest sweep's shape (M, B, N, D)
# the paper's evaluation (ROADMAP A8b) on the pretrained subject and the
# harvest sweep's export: 64 held-out sequences at the pretraining length,
# batches of 16; the ablation graphs on the first batch (32 features
# non-positional; 4 positions x 8 features positional); autointerp's device
# half over 256 fragments of 64 tokens, 200 kept features; the toy grid at
# `ToyArgs`' widths, and `run_single_go` card vs CPU at a smaller shape
EVAL = dict(rows=64, seed=31, batch=16, ablate=32, positions=(1, 32, 64, 127), pos_feats=8, cpu_rtol=1e-4)
INTERP = dict(fragments=256, seed=37, batch=32, max_features=200)
TOY = dict(epochs=400, single=dict(activation_dim=256, n_ground_truth_components=512, n_components_dictionary=1024,
                                   batch_size=1024, epochs=10))
# long-context harvest (ROADMAP A5r): layer 2 of the pretrained subject at seq
# 8192 (blockwise vs dense, JAX's pins), then 2 sequences of 32768 harvested
BLOCKWISE = dict(seq=8192, long_seq=32768, long_chunks=2, tokens_seed=41, attn_seed=43, attn_atol=2e-5,
                 capture_atol=2e-3)
# the sequence-parallel harvest (ROADMAP A6b's second part) on the pretrained
# subject: layer 2's residual at seq 8192 (the blockwise pins' length), ring
# and Ulysses against dense (JAX's pins), in a world of one over NCCL and a
# world of two processes on the one card over gloo; the world of two also
# harvests 2 sequences of 8192 tokens with each strategy (one a chunk)
SEQPAR = dict(seq=8192, harvest_seqs=2, tokens_seed=73, attn_seed=79, attn_atol=2e-5, capture_atol=2e-3, world=2,
              timeout=600)
# the run tools (ROADMAP A9's first group) over the run dirs the smoke wrote;
# the SLO objectives evaluated over the serving process' events
RUNTOOLS_SLO = {"windows": {"fast_burn_seconds": 10.0, "slow_burn_seconds": 60.0},
                "objectives": [{"name": "availability", "type": "availability", "target": 0.99},
                               {"name": "p99_latency", "type": "latency", "percentile": 0.99, "threshold_ms": 1000.0},
                               {"name": "queue_depth", "type": "queue_depth", "max_depth": 4096}]}
# the big-batch trainer (ROADMAP A6a) at RESURRECT_r04.json's hyperparameters
# and Pythia-70M's width: ratio 32, l1 1e-3, batch 4096, lr 3e-4, f32; cut:
# reinit_every 400 -> 100 and 450 steps (four resurrections, the last
# followed by 50 steps, as RESURRECT_r04's last is by 200)
BIG_BATCH = dict(ratio=32, l1=1e-3, batch=4096, lr=3e-4, steps=450, reinit_every=100, seed=47, bf16_steps=50,
                 fault_step=199, sample=16384, sample_seed=59,
                 small=dict(D=24, N=48, B=256, steps=30, rows=2048, seed=53, reinit_every=10, l1=3e-3, lr=1e-3))
# the paper's experiments (ROADMAP A8c) on the subject and the sweep's 16 dicts
PAPER = dict(pca_rows=65536, tokens=(64, 128), tokens_seed=61, token_batch=16, pca_step=8, n_sample=10000,
             fragments=(256, 64), fragments_seed=67, feature=0, connections_rows=2048, small_rows=2,
             small_fragments=8)
# serving the harvest sweep's export (ROADMAP A7a): buckets 8..1024, top-k 32,
# /features of 128-token sequences; 16 closed-loop HTTP clients; the drain's
# worker attaches a seeded random Pythia-70M (the spec both processes build)
# the profiling phase: the sweep driver over 2 fp16 chunks of 65,536 rows with
# config 2's tied ensemble (32 steps a chunk), the trace window over chunk 1
# (SC_TRACE_WINDOW in cumulative steps), the store drawn by a seeded
# RandomDatasetGenerator on the card (its repair config is JSON)
PROFILING = dict(chunks=2, chunk_size_gb=0.0625, window="32:64", audit_rows=65536,
                 generator=dict(activation_dim=D, n_ground_truth_components=1024, batch_size=4096,
                                feature_num_nonzero=8, feature_prob_decay=0.996, correlated=False, seed=83))
SERVE = dict(max_batch=1024, topk=32, seq=128, rows_seed=23, token_rows=256, tokens_seed=29, requests=200,
             clients=16, http_seconds=5.0, drain_seconds=3.0, subject_spec="random:pythia-70m:2:residual:0")
# the replicated tier (ROADMAP A7b) on that export: the replicaset CLI at its
# default max_batch 256 with 2 replicas, 8 closed-loop RouterClient threads
# (dense json of 1..64 rows and top-k 32); load windows before the kill and
# after the swap, and 8 x 25 requests a turn for the 1-vs-2-replica and
# direct-vs-router comparisons
SERVE_TIER = dict(replicas=2, clients=8, max_rows=64, topk=32, before_s=4.0, after_s=3.0, compare_requests=25,
                  seed=303, ready_timeout_s=300.0, readmit_timeout_s=180.0, swap_timeout_s=240.0)
# the shape at which the JAX package picks `_fista_kernel` (`pallas_fits`);
# at config 3 it picks `_fista_kernel_hbm_dict`
FISTA_ROW8 = dict(M=2, B=256, N=512, D=128, iters=100)
# widths that are no multiples of 4 (K_f's float4 edge masked) and a ragged batch
FISTA_RAGGED = dict(M=2, B=200, N=2050, D=130, iters=50)
# the dense K2/K3's times on the WMMA mainloop that the wgmma mainloop
# replaced (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W), by row
# variant; printed beside this run's times as "was_ms"
WMMA_MAINLOOP_MS = {"stored code, mu bf16, nu f32": 2.147, "code rebuilt, mu int8, nu bf16": 2.961,
                    "gradient out": 1.940}
# K1's, K1n's, K_d's and K_s's times in their first designs (WMMA tiles: K1
# an encode and a decode launch with the code between them in device memory,
# K_d a dense masked product, K1n three phases between block barriers, K_s
# a WMMA GEMM and a select counting with shared atomics; chip_smoke.py on an
# NVIDIA H100 80GB HBM3, 700 W); printed beside this run's as "was_ms"
FIRST_DESIGN_MS = {"tied_sae_fwd": 0.967, "tied_sae_fwd_nocode": 1.118, "topk_decode": 2.322, "topk_scores": 1.813}
# K_f's times when the host enqueued two launches an iteration (chip_smoke.py
# on an NVIDIA H100 80GB HBM3, 700 W), by its two FISTA rows' shapes
HOST_PACED_K_F_MS = {"M=2,B=256,N=512,D=128,iters=100": 7.973, "M=4,B=2048,N=2048,D=512,iters=500": 471.393}
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
REPO = Path(__file__).resolve().parent


# the run dirs the smoke keeps for the run tools' phase: name -> a copy of the
# run's *.jsonl files (the runs' own folders are temporary)
KEPT_RUNS: dict = {}
# walls a later phase prints beside its own: phase -> seconds
PHASE_WALL: dict = {}


def keep_run(name: str, src: Path, root: Path, patterns=("*.jsonl",)) -> None:
    """Copy every file under ``src`` matching ``patterns`` (``*.jsonl``: the
    event and metric logs) into ``root/name`` (the relative paths kept) and
    remember it for `phase_runtools` and `phase_features`."""
    dst = root / name
    for f in (f for pattern in patterns for f in Path(src).rglob(pattern)):
        (dst / f.relative_to(src)).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, dst / f.relative_to(src))
    check(any(dst.rglob("*.jsonl")), f"no event logs under {src} to keep")
    KEPT_RUNS[name] = dst


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around `reps` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the larger of operations over the peak of their
    type (bf16 unless given) and bytes over the memory rate. Products with
    the code c count only its non-zero entries: the work this run's data
    needs. The tied kernels' work is `ops.tied_sae_kernel.kernel_work`'s
    count, the one a captured step's ``compile`` cost reads too."""
    t_ops, t_mem = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def run_counted(torch, fn):
    """``(fn(), launches, trace_short)``: every wrapper's launch count set to
    0 just before ``fn`` and read just after (`ops/_wrap.py::LaunchCounts`:
    each launch enqueues +1 on the card beside its kernel, so a CUDA graph's
    replays count too), beside a profiler trace of the same run, which must
    never count more. Where the trace counts fewer it has dropped records
    (ROADMAP C3): ``trace_short`` names them, the wrappers' counts stand."""
    from _torch_trace import trace_shortfall, traced
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    for mod in (tk, kk, fk):
        mod.reset_launches()
    out, trace = traced(torch, fn)
    launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
    return out, launches, trace_shortfall(trace, launches)


def bf16_close(torch, a, b):
    """(fraction of elements that differ, every difference within 1 bf16 ulp
    or — where f32 summation order moves a value across zero (relu, sign) —
    within 1e-5 of the tensor's largest magnitude)."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    same_sign = (ia < 0) == (ib < 0)
    near_zero = (a.float() - b.float()).abs() <= 1e-5 * b.float().abs().max()
    ok = (ia == ib) | (same_sign & ((ia - ib).abs() <= 1)) | near_zero
    return float((ia != ib).float().mean()), bool(ok.all())


def grads_close(torch, a, b, what: str, max_rel: float = 1e-2, min_cos: float = 0.9999):
    # scaled to b's largest magnitude first, so the guards against a zero
    # norm stay negligible at any scale (Adam's nu is ~1e-16 an element)
    a, b = a.double().flatten(), b.double().flatten()
    s = float(b.abs().max()) or 1.0
    a, b = a / s, b / s
    cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-30))
    check(cos > min_cos and rel < max_rel, f"{what}: cos {cos}, max rel {rel}")
    return cos, rel


def wgmma_plans(libs):
    """The dense K2/K3's wgmma plans as the built libraries compute them
    (`sc_tied_sae_bwd_plan`): stages and dynamic shared memory bytes by
    width, code (stored or rebuilt) and int8 moment tiers."""
    out = {}
    for lib, code in (("tied_sae_bwd", "stored"), ("tied_sae_bwd_rc", "rebuilt")):
        for d in (128, 256, 512):
            for i8 in (0, 1, 2):
                got = (ctypes.c_int * 2)()
                if libs[lib].sc_tied_sae_bwd_plan(d, i8, ctypes.addressof(got)) != 0:
                    raise RuntimeError(f"sc_tied_sae_bwd_plan refused D {d}")
                out[f"d{d}_{code}_int8x{i8}"] = {"stages": got[0], "smem_bytes": got[1]}
    return out


def parse_ptxas(log: str):
    """Registers, spills and static shared memory per compiled function."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(sparse_bwd_kernel|wg_bwd_kernel|encode_kernel|decode_kernel|bwd_kernel|"
                              r"scores_kernel|select_kernel|residual_kernel|update_kernel)", name)
            tmpl = re.search(r"ILb(\d)ELb(\d)ELi(\d)E", name)
            sparse = re.search(r"sparse_bwd_kernelILb(\d)ELi(\d)ELi(\d)ELi(\d)E", name)
            dense = re.search(r"(wg_bwd_kernel|bwd_kernel)ILb(\d)ELi(\d)ELi(\d)ELb(\d)ELi(\d+)E", name)
            label = short.group(1) if short else name
            if sparse:
                label += "<adam={},mu_tier={},nu_tier={},d={}>".format(*sparse.groups()[:3], 128 * int(sparse.group(4)))
            elif dense:
                last = "d" if dense.group(1) == "wg_bwd_kernel" else "cols"
                label += "<adam={},mu_tier={},nu_tier={},rebuild={},{}={}>".format(*dense.groups()[1:5], last,
                                                                                  dense.group(6))
            elif tmpl:
                label += f"<adam={tmpl.group(1)},mu_bf16={tmpl.group(2)},cols={tmpl.group(3)}>"
            cur = {"function": label}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def phase_kernels(torch, tk):
    """Each kernel against its plain version at the main-path shapes, timed."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []

    def inputs(batch):
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        bias = torch.randn((M, N), generator=g, device=dev) * 0.01
        x = torch.randn((batch, D), generator=g, device=dev)
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(torch.bfloat16)
        return d_raw, bias, x.to(torch.bfloat16), nrm, db

    # K1
    d_raw, bias, xb, nrm, db = inputs(B)
    scale = 2.0 / (B * D)
    c_k, dxh_k, lrec_k, ll1_k = tk.tied_sae_fwd(xb, db, bias, scale)
    # the two halves of K1 meet at the bf16 code: each is held against its
    # plain half on the same inputs (the decode on the kernel's own code)
    c_p, ll1_p = tk._encode_plain(xb, db, bias)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c_k, scale)
    torch.cuda.synchronize()
    frac_c, ulp_c = bf16_close(torch, c_k, c_p)
    frac_d, ulp_d = bf16_close(torch, dxh_k, dxh_p)
    check(ulp_c and frac_c < 1e-3, f"K1 c: {frac_c} differ, within 1 ulp: {ulp_c}")
    # dxh sums 4096 products per element; the tensor cores' accumulation order
    # flips its bf16 rounding more often than c's (0.13% measured on an H100)
    check(ulp_d and frac_d < 1e-2, f"K1 dxh: {frac_d} differ, within 1 ulp: {ulp_d}")
    for name, a, b in (("l_rec", lrec_k, lrec_p), ("l_l1", ll1_k, ll1_p)):
        rel = float(((a - b).abs() / b.abs()).max())
        check(rel < 1e-3, f"K1 {name}: max rel {rel}")
    k1_err = float((dxh_k.float() - dxh_p.float()).abs().max())
    xbm = xb.expand(M, B, D)
    dbt = db.transpose(1, 2)
    k1 = dict(
        name="tied_sae_fwd", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_fwd.cu",
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:191", max_abs_err=k1_err,
        variant="pipelined encode -> decode (TMA, wgmma), code stored",
        ms=time_ms(torch, lambda: tk.tied_sae_fwd(xb, db, bias, scale), 20),
        plain_ms=time_ms(torch, lambda: tk._fwd_plain(xb, db, bias, scale), 5),
        library_ms=time_ms(torch, lambda: torch.bmm(torch.bmm(xbm, dbt), db), 20),
    )
    nnz = int((c_k != 0).sum())
    k1["bound_ms"], k1["bound_by"] = bound(*tk.kernel_work("tied_sae_fwd", M, B, N, D, nnz))
    emit("kernel", name="tied_sae_fwd", c_frac_differ=frac_c, dxh_frac_differ=frac_d,
         max_abs_err_dxh=k1_err, c_nonzero_frac=nnz / c_k.numel(), lrec=lrec_k.tolist(),
         ll1=ll1_k.tolist(), variant=k1["variant"], ms=k1["ms"], was_ms=FIRST_DESIGN_MS["tied_sae_fwd"],
         bound_ms=k1["bound_ms"], plain_ms=k1["plain_ms"], library_ms=k1["library_ms"])
    rows.append(k1)

    l1b = torch.tensor(L1_GRID, device=dev) / B

    def k2_case(batch, mu_dtype, c, dxh, xb_, d_raw_, nrm_):
        args, dmax = check_k2(torch, tk, g, mu_dtype, (xb_, dxh, c, nrm_), d_raw_, l1b,
                              f"B={batch} mu={mu_dtype}")
        emit("kernel", name="tied_sae_bwd_adam", batch=batch, mu_dtype=str(mu_dtype),
             max_abs_err_d_new=dmax)
        return args, dmax

    args, k2_err = k2_case(B, torch.bfloat16, c_k, dxh_k, xb, d_raw, nrm)
    held = args()
    xbt = xb.expand(M, B, D)
    ct = c_k.transpose(1, 2)
    k2 = dict(
        name="tied_sae_bwd_adam", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd.cu",
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255", max_abs_err=k2_err,
        variant="stored code, mu bf16, nu f32",
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held), 10),
        plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3),
        library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k),
                                           torch.bmm(ct, xbt)), 10),
    )
    k2["bound_ms"], k2["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam", M, B, N, D, nnz, mu_bytes=2))
    rows.append(k2)
    del held
    k2_case(B, torch.float32, c_k, dxh_k, xb, d_raw, nrm)
    # B = 4096: the regime that takes the batch-tiled accum kernel on the TPU
    d4, bias4, xb4, nrm4, db4 = inputs(2 * B)
    c4, dxh4, _, _ = tk.tied_sae_fwd(xb4, db4, bias4, 2.0 / (2 * B * D))
    k2_case(2 * B, torch.bfloat16, c4, dxh4, xb4, d4, nrm4)
    del d4, bias4, xb4, nrm4, db4, c4, dxh4

    # K3
    gk, gbk = tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b)
    gp, gbp = tk._grads_plain(xb, dxh_k, c_k, nrm, db, l1b)
    torch.cuda.synchronize()
    cos, rel = grads_close(torch, gk, gp, "K3 g_enc")
    grads_close(torch, gbk, gbp, "K3 g_bias")
    k3_err = float((gk - gp).abs().max())
    emit("kernel", name="tied_sae_bwd_grads", cos=cos, max_rel=rel, max_abs_err=k3_err)
    k3 = dict(
        name="tied_sae_bwd_grads", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd.cu",
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:201", max_abs_err=k3_err, variant="gradient out",
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b), 10),
        plain_ms=time_ms(torch, lambda: tk._grads_plain(xb, dxh_k, c_k, nrm, db, l1b), 3),
        library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k),
                                           torch.bmm(ct, xbt)), 10),
    )
    k3["bound_ms"], k3["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_grads", M, B, N, D, nnz))
    rows.append(k3)
    for row in (k2, k3):
        emit("kernel", name=row["name"], variant=row["variant"], ms=row["ms"], was_ms=WMMA_MAINLOOP_MS[row["variant"]],
             bound_ms=row["bound_ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"])
    return rows


def moment_bytes(m) -> int:
    from _torch_moments import moment_parts

    return sum(t.numel() * t.element_size() for t in moment_parts(m))


def check_epilogue(torch, tk, fwd, d_raw, l1b, mu_tier, nu_tier, seed_tile, gen, what, sparse=False):
    """K2's compressed epilogue against `_adam_plain` on K3's gradient (K3
    runs K2's gradient code on the same bf16 rows, so both epilogues see the
    same g; both on the route ``sparse`` names): the stochastic stores draw
    the same counter-hash bits, so int8 codes and bf16 nu agree in >= 99.9%
    of elements, never more than one code or one ulp apart, scales within
    1e-6 relative. Returns the measured agreement and a maker of fresh K2
    arguments at these tiers."""
    from _torch_moments import adam_moments, clone_moment, stored_agreement

    xb, dxh, c, nrm = fwd
    M = d_raw.shape[0]
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    g, gb = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=sparse)
    mu, nu = adam_moments(d_raw, mu_tier, nu_tier, gen)
    bc = adam_bc(torch, M, 10, d_raw.device)
    d_k, mu_k, nu_k, gb_k = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu),
                                                 clone_moment(nu), l1b, bc, LR, B1, B2, EPS, seed=11,
                                                 seed_tile=seed_tile, sparse=sparse)
    d_p, mu_p, nu_p = tk._adam_plain(g, d_raw, mu, nu, bc, LR, B1, B2, EPS, seed=11, seed_tile=seed_tile)
    torch.cuda.synchronize()
    check(torch.equal(gb_k, gb), f"{what}: K2's g_bias differs from K3's")
    d_err = float((d_k - d_p).abs().max())
    check(d_err <= 1e-6, f"{what}: |d_new - plain| {d_err}")
    out = {"max_abs_err_d_new": d_err}
    for name, got, want, stochastic in (("mu", mu_k, mu_p, mu_tier == "int8"),
                                        ("nu", nu_k, nu_p, nu_tier in ("int8", "bfloat16"))):
        eq, worst, rel = stored_agreement(got, want)
        out[f"{name}_equal_share"], out[f"{name}_max_step_diff"], out[f"{name}_scale_rel"] = eq, worst, rel
        if stochastic:
            check(eq >= 0.999 and worst <= 1 and rel <= 1e-6, f"{what} {name}: equal {eq}, worst {worst}, scale {rel}")

    def args():
        return (xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu), l1b, bc,
                LR, B1, B2, EPS)
    return out, args, (g, mu, nu, bc)


def check_unbiased(torch, tk, fwd, d_raw, l1b, plain, seeds: int = 64):
    """Over ``seeds`` step seeds, the mean error of K2's stored moments
    against the f32 moment (in units of each element's storage step: the
    row's scale for int8, the bf16 spacing for bf16) within 4 sigma of 0."""
    from _torch_moments import clone_moment, store_error_steps
    from sparse_coding__tpu_torch.utils.optim import dequant, f32

    xb, dxh, c, nrm = fwd
    g, mu, nu, bc = plain

    f = {"mu": f32(B1, g) * dequant(mu) + f32(1 - B1, g) * g,
         "nu": f32(B2, g) * dequant(nu) + f32(1 - B2, g) * g * g}
    sums = {k: [0.0, 0.0, 0] for k in f}
    for seed in range(1, seeds + 1):
        _, mu_k, nu_k, _ = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu),
                                                clone_moment(nu), l1b, bc, LR, B1, B2, EPS, seed=seed)
        for name, got in (("mu", mu_k), ("nu", nu_k)):
            e = store_error_steps(got, f[name])
            sums[name][0] += float(e.sum())
            sums[name][1] += float((e * e).sum())
            sums[name][2] += e.numel()
    out = {}
    for name, (s1, s2, n) in sums.items():
        mean = s1 / n
        sd = math.sqrt(max(s2 / n - mean * mean, 0.0))
        sigmas = abs(mean) / (sd / math.sqrt(n)) if sd > 0 else 0.0
        check(sigmas <= 4, f"stochastic store {name}: mean error {mean} steps, {sigmas} sigma from 0")
        out[f"{name}_mean_err_steps"], out[f"{name}_sigmas"] = mean, sigmas
    return out


def rebuild_gemms(torch, xbm, dbt, dxh):
    """K2's four GEMMs with the code rebuilt, as bf16 `bmm` calls: c = x·D̂ᵀ,
    dc = dxh·D̂ᵀ, cᵀ·dxh, dcᵀ·x (no epilogues)."""
    c = torch.bmm(xbm, dbt)
    dc = torch.bmm(dxh, dbt)
    return torch.bmm(c.transpose(1, 2), dxh), torch.bmm(dc.transpose(1, 2), xbm)


def phase_capacity_kernels(torch, tk):
    """The tied-capacity path's kernels at its shapes (config 2), timed:
    K1n against K1 (dxh bit-equal, the loss sums' difference stated) and its
    plain version; K2 rebuilding the code against K2 on K1's stored code
    (d_new, moments and g_bias bit-equal); K2's compressed epilogues against
    the plain version; the stores' unbiasedness over 64 seeds."""
    from _torch_moments import adam_moments, clone_moment, same_bits

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
    bias = torch.randn((M, N), generator=g, device=dev) * 0.01
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    scale = 2.0 / (B * D)
    src_fwd = "sparse_coding__tpu_torch/ops/csrc/tied_sae_fwd.cu"
    rows = []

    # K1n against K1 and against its plain version on K1's code (K1n's own)
    c_k, dxh_k, lrec_k, ll1_k = tk.tied_sae_fwd(xb, db, bias, scale)
    dxh_n, lrec_n, ll1_n = tk.tied_sae_fwd_nocode(xb, db, bias, scale)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c_k, scale)
    again = tk.tied_sae_fwd_nocode(xb, db, bias, scale)
    torch.cuda.synchronize()
    check(torch.equal(dxh_n.view(torch.int16), dxh_k.view(torch.int16)), "K1n dxh differs from K1's")
    check(all(same_bits(a, b) for a, b in zip((dxh_n, lrec_n, ll1_n), again)), "K1n: two launches differ")
    del again
    lrec_rel = float(((lrec_n - lrec_k).abs() / lrec_k.abs()).max())
    ll1_rel = float(((ll1_n - ll1_k).abs() / ll1_k.abs()).max())
    check(lrec_rel < 1e-5 and ll1_rel < 1e-5, f"K1n loss sums vs K1: {lrec_rel}, {ll1_rel}")
    frac_d, ulp_d = bf16_close(torch, dxh_n, dxh_p)
    check(ulp_d and frac_d < 1e-2, f"K1n dxh: {frac_d} differ from plain, within 1 ulp: {ulp_d}")
    for name, a, b in (("l_rec", lrec_n, lrec_p), ("l_l1", ll1_n, ll1_k)):
        rel = float(((a - b).abs() / b.abs()).max())
        check(rel < 1e-3, f"K1n {name}: max rel {rel}")
    nnz = int((c_k != 0).sum())
    xbm, dbt = xb.expand(M, B, D), db.transpose(1, 2)
    k1n = dict(
        name="tied_sae_fwd_nocode", source=src_fwd, replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:195",
        max_abs_err=float((dxh_n.float() - dxh_p.float()).abs().max()), variant="no code stored",
        ms=time_ms(torch, lambda: tk.tied_sae_fwd_nocode(xb, db, bias, scale), 20),
        plain_ms=time_ms(torch, lambda: tk._fwd_nocode_plain(xb, db, bias, scale), 5),
        library_ms=time_ms(torch, lambda: torch.bmm(torch.bmm(xbm, dbt), db), 20),
    )
    k1n["bound_ms"], k1n["bound_by"] = bound(*tk.kernel_work("tied_sae_fwd_nocode", M, B, N, D, nnz))
    summary = dict(k1n_dxh_bit_equal_k1=True, k1n_same_bits_twice=True, k1n_lrec_rel_vs_k1=lrec_rel,
                   k1n_ll1_rel_vs_k1=ll1_rel, k1n_dxh_frac_differ_plain=frac_d, k1n_ms=k1n["ms"],
                   k1n_was_ms=FIRST_DESIGN_MS["tied_sae_fwd_nocode"])
    rows.append(k1n)
    del c_k  # from here on the code exists only inside the kernels that need it

    l1b = torch.tensor(L1_GRID, device=dev) / B
    c_k, _, _, _ = tk.tied_sae_fwd(xb, db, bias, scale)
    fwd = (xb, dxh_k, c_k, nrm)
    # K2 rebuilding the code == K2 on K1's stored code, bit for bit
    bc = adam_bc(torch, M, 10, dev)
    for mu_t, nu_t in (("bfloat16", "float32"), ("int8", "bfloat16")):
        mu, nu = adam_moments(d_raw, mu_t, nu_t, g)
        outs = [tk.tied_sae_bwd_adam(xb, dxh_k, code, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu),
                                     l1b, bc, LR, B1, B2, EPS, seed=7, bias=b)
                for code, b in ((c_k, None), (None, bias))]
        torch.cuda.synchronize()
        equal = all(same_bits(a, b) for a, b in zip(*outs))
        check(equal, f"K2 rebuild (mu {mu_t}, nu {nu_t}) differs from K2 on the stored code")
        summary[f"k2_rebuild_bit_equal_mu_{mu_t}_nu_{nu_t}"] = equal
    # the compressed epilogues against the plain version on the same g
    for mu_t, nu_t in (("int8", "bfloat16"), ("int8", "int8"), ("float32", "bfloat16")):
        agree, args, plain = check_epilogue(torch, tk, fwd, d_raw, l1b, mu_t, nu_t, tk.TIED_SEED_TILE, g,
                                            f"K2 epilogue mu {mu_t}, nu {nu_t}")
        summary[f"k2_epilogue_mu_{mu_t}_nu_{nu_t}"] = agree
        if (mu_t, nu_t) == ("int8", "bfloat16"):
            cap_agree, cap_args, cap_plain = agree, args, plain
    summary["k2_stores_unbiased_64_seeds"] = check_unbiased(torch, tk, fwd, d_raw, l1b, cap_plain)
    emit("capacity_kernels", shape=f"M={M},B={B},N={N},D={D}", **summary)
    del c_k
    # the tied-capacity path's K2: the code rebuilt, int8 mu, bf16 nu
    held = list(cap_args())
    held[2] = None

    def k2_cap(a):
        return tk.tied_sae_bwd_adam(*a, seed=3, bias=bias)

    def k2_cap_plain(a):
        xb_, dxh_, _, nrm_, d_, mu_, nu_, l1b_, bc_ = a[:9]
        dj = (d_ / nrm_[..., None]).to(torch.bfloat16)
        gr, gbias = tk._grads_plain(xb_, dxh_, None, nrm_, dj, l1b_, bias)
        return (*tk._adam_plain(gr, d_, mu_, nu_, bc_, LR, B1, B2, EPS, seed=3), gbias)

    def fresh():
        a = list(cap_args())
        a[2] = None
        return a

    k2 = dict(
        name="tied_sae_bwd_adam", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd_rc.cu",
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255", variant="code rebuilt, mu int8, nu bf16",
        max_abs_err=cap_agree["max_abs_err_d_new"],
        ms=time_ms(torch, lambda: k2_cap(held), 10),
        plain_ms=time_ms(torch, lambda: k2_cap_plain(fresh()), 3),
        library_ms=time_ms(torch, lambda: rebuild_gemms(torch, xbm, dbt, dxh_k), 10),
    )
    # the rebuild's dense encode GEMM + the three on the code's non-zeros;
    # moments: int8 codes and scales, bf16 nu, each read and written once
    k2["bound_ms"], k2["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam_rc", M, B, N, D, nnz, mu_bytes=1,
                                                           nu_bytes=2, mu_scaled=True))
    rows.append(k2)
    emit("kernel", name=k2["name"], variant=k2["variant"], ms=k2["ms"], was_ms=WMMA_MAINLOOP_MS[k2["variant"]],
         bound_ms=k2["bound_ms"], plain_ms=k2["plain_ms"], library_ms=k2["library_ms"])
    # where K2's extra time goes: each change alone, timed in this phase
    c_k, _, _, _ = tk.tied_sae_fwd(xb, db, bias, scale)
    parts = {}
    for label, code, b, tiers in (("stored_code_mu_bf16_nu_f32", c_k, None, ("bfloat16", "float32")),
                                  ("rebuild_mu_bf16_nu_f32", None, bias, ("bfloat16", "float32")),
                                  ("stored_code_mu_int8_nu_bf16", c_k, None, ("int8", "bfloat16"))):
        mu, nu = adam_moments(d_raw, *tiers, g)
        a = (xb, dxh_k, code, nrm, d_raw.clone(), mu, nu, l1b, bc, LR, B1, B2, EPS)
        parts[f"{label}_ms"] = time_ms(torch, lambda: tk.tied_sae_bwd_adam(*a, seed=3, bias=b), 10)
    emit("kernel", name="tied_sae_bwd_adam", variant="time by change, config 2",
         rebuild_mu_int8_nu_bf16_ms=k2["ms"], **parts)
    del held, c_k
    return rows


def k2_args(fwd, d_raw, mu, nu, l1b, bc):
    """A maker of fresh K2 arguments (K2 updates d_raw, mu and nu in place);
    ``fwd`` is (xb, dxh, c, nrm)."""
    return lambda: (*fwd, d_raw.clone(), mu.clone(), nu.clone(), l1b, bc, LR, B1, B2, EPS)


def adam_bc(torch, members: int, t: int, dev):
    """The bias corrections (1 - b1^t, 1 - b2^t) of Adam step t, per member."""
    return torch.tensor([[1 - B1 ** t, 1 - B2 ** t]] * members, device=dev)


def ulp(torch, t):
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def check_k2(torch, tk, gen, mu_dtype, fwd, d_raw, l1b, what: str, sparse: bool = False):
    """K2 against its plain version on the same inputs, at two Adam steps:
      - step 1, from zero moments: mu_new = (1 - b1)·g exactly, so the moments
        hold the kernel's gradient against the plain one, member by member
        (cosine > 0.9999, max error < 1e-2 of the max);
      - step 10, from moments drawn at each member's gradient scale, so the
        decayed moments and g weigh alike in the update.
    At both, d_new is held elementwise against the Adam update recomputed
    from the kernel's own new moments (`hold_k2`), and within 2 lr of the
    plain d_new. ``sparse`` picks K2's route. Returns (a maker of step 10's
    arguments, the largest |d_new| difference from the plain version)."""
    M, dev = d_raw.shape[0], d_raw.device
    zeros = torch.zeros_like(d_raw)
    first = k2_args(fwd, d_raw, zeros.to(mu_dtype), zeros, l1b, adam_bc(torch, M, 1, dev))
    err1, mu1 = hold_k2(torch, tk, first, f"{what} step 1", sparse)
    g_rms = mu1.float().pow(2).mean(dim=(1, 2), keepdim=True).sqrt() / (1 - B1)
    mu = (torch.randn(d_raw.shape, generator=gen, device=dev) * g_rms).to(mu_dtype)
    nu = torch.rand(d_raw.shape, generator=gen, device=dev) * g_rms * g_rms
    later = k2_args(fwd, d_raw, mu, nu, l1b, adam_bc(torch, M, 10, dev))
    err10, _ = hold_k2(torch, tk, later, f"{what} step 10", sparse)
    return later, max(err1, err10)


def hold_k2(torch, tk, args, what: str, sparse: bool = False):
    """One K2 launch against `_k2_plain`: g_bias and, per member, the new
    moments as gradients; d_new within 2 ulp of d_raw - lr·m̂/(√v̂ + eps) on
    the kernel's own new moments (plus 2^-8 of the update with bf16 mu: the
    kernel steps from the f32 mu before its bf16 store). Returns (the largest
    |d_new| difference from plain, the plain mu_new)."""
    p = args()
    dk, mk, nk, gbk = tk.tied_sae_bwd_adam(*args(), sparse=sparse)
    dp, mp, np_, gbp = _k2_plain(tk, *p)
    torch.cuda.synchronize()
    grads_close(torch, gbk, gbp, f"K2 {what} g_bias")
    for m in range(mk.shape[0]):
        grads_close(torch, mk[m].float(), mp[m].float(), f"K2 {what} mu[{m}]")
        grads_close(torch, nk[m], np_[m], f"K2 {what} nu[{m}]")
    bc = p[8]
    upd = LR * (mk.float() / bc[:, 0, None, None]) / (torch.sqrt(nk / bc[:, 1, None, None]) + EPS)
    d_own = p[4] - upd
    slack = 2 * ulp(torch, d_own) + 2 * ulp(torch, upd)
    if mk.dtype == torch.bfloat16:
        slack = slack + upd.abs() * 2.0 ** -8
    excess = float(((dk - d_own).abs() - slack).max())
    check(excess <= 0, f"K2 {what}: d_new off its own moments' update by {excess} past the slack")
    dmax = float((dk - dp).abs().max())
    check(dmax <= 2 * LR, f"K2 {what}: |d_new diff| {dmax} > 2 lr")
    return dmax, mp


def _k2_plain(tk, xb, dxh, c, nrm, d_raw, mu, nu, l1b, bc, lr, b1, b2, eps):
    """K2's plain version on CUDA tensors (the wrapper sends CUDA to the kernel)."""
    import torch

    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, g_bias = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    return (*tk._adam_plain(gr, d_raw, mu, nu, bc, lr, b1, b2, eps), g_bias)


@contextlib.contextmanager
def environ(env):
    """The process environment with ``env`` set, restored afterwards (the
    fused step reads SC_RECOMPUTE_CODE when an ensemble is built)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def build_path(pkg, cfg, key: int):
    with environ(cfg["env"]):
        ens = pkg.build_ensemble(getattr(pkg, cfg["sig"]), key, cfg["hparams"], **cfg["build"])
    check(ens.fused and ens.fused_adam is not None, f"{cfg['path']}: fused {ens.fused}, fused_adam {ens.fused_adam}")
    check(ens.fused_adam.get("recompute_code", False) == bool(cfg["env"]), f"{cfg['path']}: {ens.fused_adam}")
    return ens


def synthetic_store(torch, cfg):
    """A path's data: a two-chunk store of its synthetic activations in its
    tier, in a temporary directory. Returns (the directory, the generator,
    the store, an evaluation batch of two generator batches)."""
    import numpy as np

    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    width = cfg["width"]
    tmp = tempfile.TemporaryDirectory(prefix=f"sc_chip_smoke_{cfg['prefix']}")
    gen = RandomDatasetGenerator(activation_dim=width, batch_size=4096, correlated=False, **cfg["data"])
    rows, dtype = cfg["rows_per_chunk"], np.dtype(cfg["store_dtype"])
    store = generate_synthetic_chunks(gen, Path(tmp.name) / "store", 2,
                                      chunk_size_gb=rows * width * dtype.itemsize / 1024**3, dtype=dtype)
    check(store.indices() == [0, 1], f"store indices {store.indices()}")
    check(np.load(Path(tmp.name) / "store" / "0.npy", mmap_mode="r").dtype == dtype, "chunk tier")
    return tmp, gen, store, torch.cat([next(gen) for _ in range(2)])


def phase_train(torch, pkg, cfg):
    """A path's main run: chunk store → ensemble_train_loop → one masked
    step, its launches counted (`run_counted`: the wrappers' counts, a
    graph replay's included, beside a profiler trace). Every step of the
    loop (graph replays but the capture's first) runs the path's forward
    kernels and K2 on the path's route (dense for tied, sparse for TopK);
    the masked step runs the masked forward kernels and K3 on that route;
    nothing else runs. ``wall_s`` is traced (see `phase_loop_wall` for the
    untraced loop)."""
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
    from sparse_coding__tpu_torch.utils import precision as px

    sig, members, batch = getattr(pkg, cfg["sig"]), cfg["members"], cfg["batch"]
    tmp, gen, store, eval_batch = synthetic_store(torch, cfg)
    ens = build_path(pkg, cfg, 0)
    leaf = next(iter(ens.state.params))  # the dictionary: "encoder" or "dict"

    def eval_loss():
        st = ens.state
        with torch.no_grad(), px.compute(torch.bfloat16):
            total, _ = sig.loss(st.params, st.buffers, eval_batch[:batch])
        return total

    def loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps, last = 0, None
        for i, chunk in enumerate(store.iter_chunks([0, 1])):
            last = ensemble_train_loop(ens, chunk, batch, key=i)
            steps += chunk.shape[0] // batch
        torch.cuda.synchronize()
        return steps, last, time.perf_counter() - t0

    loss0 = eval_loss()
    (steps, last, wall), loop_launches, loop_short = run_counted(torch, loop)
    want = {name: 0 for name in loop_launches}
    want.update({name: steps for name in (*cfg["fwd_kernels"], cfg["bwd_adam"])})
    check(loop_launches == want, f"launches {loop_launches} after {steps} steps, want {want}")
    captures = ens.captures
    check(captures == 1, f"{captures} graph captures over the loop's chunks, want 1")
    # one masked step: the fused-Adam kernel gives way to fused grads (K3)
    frozen = ens.state.params[leaf][members - 1].clone()
    ens.set_update_mask([1.0] * (members - 1) + [0.0])
    (masked_loss, _), masked_launches, masked_short = run_counted(
        torch, lambda: ens.step_batch(eval_batch[batch:2 * batch]))
    launches = {name: n + masked_launches[name] for name, n in loop_launches.items()}
    for name in cfg["masked_fwd"]:
        want[name] += 1
    want[cfg["bwd_grads"]] = 1
    check(launches == want, f"launches {launches} after {steps} + 1 masked steps, want {want}")
    check(torch.equal(frozen, ens.state.params[leaf][members - 1]), "masked member moved")
    moments = ens.state.opt_state
    tiers = {k: [type(m[leaf]).__name__ if hasattr(m[leaf], "q") else str(m[leaf].dtype)]
             for k, m in (("mu", moments.mu), ("nu", moments.nu))}
    loss1 = eval_loss()
    finite = all(bool(torch.isfinite(v).all()) for v in (*last.values(), *masked_loss.values(), loss1))
    check(finite, "non-finite loss")
    check(float(loss1.mean()) < float(loss0.mean()), f"mean loss did not fall: {loss0} -> {loss1}")
    emit(
        f"{cfg['prefix']}train", path=cfg["path"], steps=steps, batch=batch, members=members,
        store_dtype=cfg["store_dtype"], moments=tiers, recompute_code=bool(cfg["env"]),
        wall_s=wall, activations_per_s=steps * batch * members / wall, loss_before=loss0.tolist(),
        loss_after=loss1.tolist(), last_step_loss=last["loss"].tolist(),
        launches_after_loop=loop_launches, launches=launches, graph_captures=captures,
        capture_s=ens.capture_seconds, trace_short={"loop": loop_short, "masked": masked_short},
    )
    return ens, gen, eval_batch, tmp, store, launches


def phase_loop_wall(torch, pkg, cfg, store, runs: int = 2):
    """The train loop's wall over the path's two chunks, untraced, on the
    graph (`ensemble_train_loop`) and eager (the loop's whole-chunk route
    with one `step_batch` a batch: the same shuffle and dead-ensemble probe),
    ``runs`` times each in turns from fresh ensembles: the seconds spent
    waiting for a chunk, in the one capture, and in all. The graph's final
    state must be the eager one's bits."""
    from _torch_moments import state_differences
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop, warn_if_ensemble_dead

    batch = cfg["batch"]

    def eager_loop(ens, chunk, key):
        n = chunk.shape[0]
        nb = n // batch
        gen = torch.Generator(device=chunk.device).manual_seed(int(key))
        perm = torch.randperm(n, generator=gen, device=chunk.device)
        for b in chunk[perm[: nb * batch]].reshape(nb, batch, -1):
            ens.step_batch(b)
        warn_if_ensemble_dead(ens, chunk[perm[:64]], context="after chunk pass")

    out = {"graph": [], "eager": []}
    final = {}
    for run in range(2 * runs):
        route = ("graph", "eager")[run % 2]
        ens = build_path(pkg, cfg, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load, steps = 0.0, 0
        chunks = store.iter_chunks([0, 1])
        for i in range(2):
            t1 = time.perf_counter()
            chunk = next(chunks)
            load += time.perf_counter() - t1
            steps += chunk.shape[0] // batch
            if route == "graph":
                ensemble_train_loop(ens, chunk, batch, key=i)
            else:
                eager_loop(ens, chunk, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks.close()
        out[route].append({"wall_s": wall, "chunk_wait_s": load, "capture_s": ens.capture_seconds,
                           "captures": ens.captures})
        final[route] = ens.state
        del ens
    diff = state_differences(final["graph"], final["eager"])
    check(diff == [], f"{cfg['path']}: the graph loop's state differs from the eager loop's at {diff}")
    emit(f"{cfg['prefix']}loop_wall", path=cfg["path"], chunks=2, batch=batch,
         steps=steps, graph=out["graph"], eager=out["eager"], bit_equal=True)


def phase_step_time(torch, pkg, cfg, reps: int = 20):
    """The fused-Adam step on a batch already on the card, eager
    (`step_batch`) and as graph replays (`step_scan` over ``reps`` batches,
    after a call that captured the step): CUDA-event time per step beside
    the host's time to enqueue it (enqueue << step means the card, not the
    host, sets the pace), and the peak device memory of a step with the
    ensemble's state resident (`max_memory_allocated` over the steps, the
    graph's capture included, less what was allocated before the ensemble
    was built). On the tied paths the graph's enqueue must be at most a
    quarter of its step. Returns the two peaks in bytes, eager and graph."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ens = build_path(pkg, cfg, 1)
    batch, width = cfg["batch"], cfg["width"]
    x = torch.randn((batch, width), device="cuda")
    for _ in range(3):
        ens.step_batch(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        ens.step_batch(x)
    end.record()
    enqueue = time.perf_counter() - t0
    end.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    emit(f"{cfg['prefix']}step", path=cfg["path"], steps=reps, ms_per_step=start.elapsed_time(end) / reps,
         host_enqueue_ms_per_step=enqueue * 1e3 / reps, wall_ms_per_step=wall * 1e3 / reps,
         activations_per_s=reps * batch * ens.n_models / wall, step_peak_bytes=peak)
    # the same step as replays of its captured graph: the batch copied into
    # the graph's input before each replay, the losses copied out after it
    xs = x.unsqueeze(0).expand(reps, batch, width)
    torch.cuda.reset_peak_memory_stats()
    ens.step_scan(xs[:3])
    torch.cuda.synchronize()
    # what can land in the timed window: the garbage collector's pauses and
    # new device segments are counted there, and further calls' enqueues
    # are timed each in its own window
    gc_ms = []

    def gc_timer(phase, info, t=[0.0]):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            gc_ms.append((time.perf_counter() - t[0]) * 1e3)

    gc.callbacks.append(gc_timer)
    segments0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    try:
        t0 = time.perf_counter()
        start.record()
        losses = ens.step_scan(xs)
        end.record()
        enqueue_g = time.perf_counter() - t0
        end.synchronize()
        wall_g = time.perf_counter() - t0
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments0
        # the enqueue of further calls, each its own window
        repeat = []
        for _ in range(4):
            t1 = time.perf_counter()
            ens.step_scan(xs)
            repeat.append((time.perf_counter() - t1) * 1e3 / reps)
            torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(gc_timer)
    peak_g = torch.cuda.max_memory_allocated() - before
    torch.cuda.empty_cache()
    pinned = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    ms_g = start.elapsed_time(end) / reps
    check(ens.captures == 1 and bool(torch.isfinite(losses["loss"]).all()),
          f"{cfg['path']}: {ens.captures} captures, losses {losses['loss'][-1]}")
    if cfg["prefix"] in ("", "capacity_"):
        check(enqueue_g * 1e3 / reps <= ms_g / 4,
              f"{cfg['path']}: graph enqueue {enqueue_g * 1e3 / reps} ms of a {ms_g} ms step")
    emit(f"{cfg['prefix']}step_scan", path=cfg["path"], steps=reps, ms_per_step=ms_g,
         host_enqueue_ms_per_step=enqueue_g * 1e3 / reps, wall_ms_per_step=wall_g * 1e3 / reps,
         repeated_enqueue_ms_per_step=repeat, gc_pauses_ms=gc_ms, segments_allocated_in_window=segments,
         activations_per_s=reps * batch * ens.n_models / wall_g, step_peak_bytes=peak_g,
         reserved_unallocated_bytes=pinned)
    return peak, peak_g


def phase_graph_parity(torch, pkg, cfg, steps: int = 8):
    """The captured step against the eager one at the path's full width:
    from cloned states, ``steps`` graph replays (`step_scan`, after a call
    that captured the step) and ``steps`` eager `step_batch` calls give the
    same losses and the same state bit for bit (params, moments with int8
    codes and scales, count, step), and launch the same kernels as often
    (`run_counted`)."""
    from _torch_moments import state_differences

    a = build_path(pkg, cfg, 2)
    with environ(cfg["env"]):
        b = pkg.Ensemble.from_state(a.state_dict(), sig=a.sig, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    xs = torch.randn((steps + 1, cfg["batch"], cfg["width"]), generator=g, device="cuda")
    a.step_scan(xs[:1])
    b.step_batch(xs[0])
    counts = [run_counted(torch, run) for run in (lambda: a.step_scan(xs[1:]),
                                                  lambda: [b.step_batch(x)[0] for x in xs[1:]])]
    (la, ga, sa), (lb, gb, sb) = counts
    check(a.captures == 1, f"{cfg['path']}: {a.captures} captures")
    check(ga == gb and all(ga[k] == steps for k in (*cfg["fwd_kernels"], cfg["bwd_adam"]))
          and sum(ga.values()) == steps * (len(cfg["fwd_kernels"]) + 1),
          f"{cfg['path']}: graph launched {ga}, eager {gb}")
    for k in lb[0]:
        check(torch.equal(la[k], torch.stack([l[k] for l in lb])), f"{cfg['path']}: graph {k} differs from eager")
    diff = state_differences(a.state, b.state)
    check(diff == [], f"{cfg['path']}: graph state differs from eager at {diff}")
    emit(f"{cfg['prefix']}graph_parity", path=cfg["path"], steps=steps, members=a.n_models, batch=cfg["batch"],
         captures=a.captures, launches=ga, bit_equal=True, step=a.state.step,
         trace_short={"graph": sa, "eager": sb})
    del a, b


def phase_small_parity(torch, pkg, sig, hparams, optimizer_kwargs, env=None, **kw):
    """A few fused steps at a small shape (D 128, N 512, batch 256) on the
    card and on the CPU (the plain versions) from the same state must agree:
    losses within 1e-3, the dictionary within 2 lr per step, and its median
    difference under 1/20 of the median distance the steps moved it (so a
    step that left the dictionary alone fails). With int8 mu (whose
    stochastic store draws the same counter-hash bits on both) a code that
    one side's f32 sums put across a rounding boundary moves a
    small-gradient element's next update by up to ~lr·step/|g|: there the
    bulk (median) within lr per step and every element within 50 lr, the
    envelope of the JAX package's int8 two-step test; and after the first
    step, from the same state, >= 99% of mu's int8 codes equal (streams of
    other seeds agree on about half)."""
    kw = dict(optimizer_kwargs=optimizer_kwargs, compute_dtype="bfloat16", **kw)
    int8 = optimizer_kwargs.get("mu_dtype") == "int8"
    with environ(env or {}):
        ens_c = pkg.build_ensemble(sig, 3, hparams, device="cpu", **kw)
        ens_g = pkg.build_ensemble(sig, 3, hparams, device="cpu", **kw)
        ens_g = pkg.Ensemble.from_state(ens_g.state_dict(), device="cuda")
    name = sig.__name__
    check(ens_g.fused_adam is not None, f"small parity {name}: the fused-Adam path is off")
    leaf = next(iter(ens_c.state.params))  # the dictionary: "encoder" or "dict"
    start = ens_c.state.params[leaf].clone()
    x = torch.randn((3, 256, 128), generator=torch.Generator().manual_seed(5))
    worst_loss, worst_param, ratio, codes_equal = 0.0, 0.0, 0.0, []
    for k in range(3):
        lc, _ = ens_c.step_batch(x[k])
        lg, _ = ens_g.step_batch(x[k].cuda())
        worst_loss = max(worst_loss, float(((lg["loss"].cpu() - lc["loss"]) / lc["loss"]).abs().max()))
        diff = (ens_g.state.params[leaf].cpu() - ens_c.state.params[leaf]).abs()
        dp, med = float(diff.max()), float(diff.median())
        moved = float((ens_c.state.params[leaf] - start).abs().median())
        worst_param, ratio = max(worst_param, dp), max(ratio, med / max(moved, 1e-30))
        check(worst_loss < 1e-3, f"small parity {name}: loss rel {worst_loss}")
        ok = (med <= LR * (k + 1) and dp <= 50 * LR) if int8 else dp <= 2 * LR * (k + 1)
        check(ok, f"small parity {name}: {leaf} diff max {dp}, median {med} after {k + 1} steps")
        check(moved > 0.5 * LR and med < 0.05 * moved,
              f"small parity {name}: {leaf} moved {moved} (median), card vs CPU median {med} after {k + 1} steps")
        if int8:
            qg, qc = ens_g.state.opt_state.mu[leaf].q.cpu(), ens_c.state.opt_state.mu[leaf].q
            codes_equal.append(float((qg == qc).float().mean()))
            check(k > 0 or codes_equal[0] >= 0.99, f"small parity {name}: {codes_equal[0]} of mu's int8 codes equal")
    emit("small_parity", sig=name, moments={k: str(v) for k, v in optimizer_kwargs.items()},
         recompute_code=bool(env), steps=3, max_loss_rel=worst_loss, max_dict_diff=worst_param,
         max_median_diff_over_moved=ratio, mu_int8_codes_equal=codes_equal or None)


def phase_eval_export(torch, cfg, ens, gen, eval_batch, tmp):
    """A path's learned dictionaries: finite metrics (each member's mean L0
    within its bound, where the path has one), and a save/load round trip
    that keeps the class, the hyperparameters and the codes."""
    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts, mmcs_to_fixed
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    lds = ens.to_learned_dicts()
    metrics = evaluate_dicts(lds, eval_batch)
    mmcs = [float(mmcs_to_fixed(ld, gen.feats)) for ld in lds]
    for i, row in enumerate(metrics):
        check(math.isfinite(row["fvu"]) and math.isfinite(row["l0"]), f"metrics {row}")
        if cfg["l0_max"] is not None:
            check(row["l0"] <= cfg["l0_max"][i], f"member {i}: mean L0 {row['l0']} > {cfg['l0_max'][i]}")
    path = Path(tmp.name) / "learned_dicts.pkl"
    save_learned_dicts(path, list(zip(lds, cfg["hparams"])))
    loaded = load_learned_dicts(path, verify=True)
    check(len(loaded) == cfg["members"], "export lost members")
    for ld, hp, (ld2, hp2) in zip(lds, cfg["hparams"], loaded):
        check(type(ld2) is type(ld) and hp2 == hp, f"loaded {type(ld2).__name__} {hp2}, saved {hp}")
        check(torch.equal(ld.encode(eval_batch[:256]), ld2.encode(eval_batch[:256])), "codes differ after export")
    emit(f"{cfg['prefix']}eval_export", path=cfg["path"], hparams=cfg["hparams"],
         fvu=[r["fvu"] for r in metrics], l0=[r["l0"] for r in metrics], mmcs=mmcs)


def phase_topk_kernels(torch, tk, kk):
    """K_s and K_d, and K2/K3 at D 768, against their plain versions at the
    TopK path's shapes (BASELINE config 4), timed."""
    from sparse_coding__tpu_torch.ops import _build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    d_raw = torch.randn((TM, TN, TD), generator=g, device=dev)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    xb = torch.randn((TB, TD), generator=g, device=dev).to(torch.bfloat16)
    k = torch.tensor(TOPK_KS, dtype=torch.int32, device=dev)
    scale = 2.0 / (TB * TD)
    src = "sparse_coding__tpu_torch/ops/csrc/topk_fwd.cu"
    shape = f"M={TM},B={TB},N={TN},D={TD}"
    rows = []

    # K_s: the scores within 1 ulp of the plain GEMM's; the plain select on
    # the kernel's own scores gives the same threshold bits, and so does the
    # select alone (its C entry, off the path) on them
    s_k, th_k = kk.topk_scores(xb, db, k)
    s_p, _ = kk._topk_scores_plain(xb, db, k)
    th_p = kk._select_plain(s_k, k)
    th_alone = torch.empty_like(th_k)
    fwd_lib = _build.load()["topk_fwd"]
    st = torch.cuda.current_stream(dev).cuda_stream

    def select_alone():
        return fwd_lib.sc_topk_select(s_k.data_ptr(), k.data_ptr(), th_alone.data_ptr(), TM, TB, TN, st)

    _build.check(select_alone(), "topk_select")
    torch.cuda.synchronize()
    frac_s, ulp_s = bf16_close(torch, s_k, s_p)
    check(ulp_s and frac_s < 1e-3, f"K_s s: {frac_s} differ, within 1 ulp: {ulp_s}")
    check(torch.equal(th_k.view(torch.int32), th_p.view(torch.int32)),
          "K_s thresholds differ from the plain select on the kernel's scores")
    check(torch.equal(th_alone.view(torch.int32), th_p.view(torch.int32)),
          "K_s's select alone differs from the plain select")
    ks_err = float((s_k.float() - s_p.float()).abs().max())
    del s_p, th_p
    xbm = xb.expand(TM, TB, TD)
    dbt = db.transpose(1, 2)
    row = dict(
        name="topk_scores", source=src, replaces="sparse_coding__tpu/ops/topk_kernel.py:98",
        max_abs_err=ks_err, shape=shape, variant="TMA + wgmma scores, select on fp16 counts",
        ms=time_ms(torch, lambda: kk.topk_scores(xb, db, k), 10),
        plain_ms=time_ms(torch, lambda: kk._topk_scores_plain(xb, db, k), 3),
        library_ms=time_ms(torch, lambda: torch.topk(torch.bmm(xbm, dbt), max(TOPK_KS), dim=-1), 10),
    )
    row["bound_ms"], row["bound_by"] = bound(
        2 * TM * TB * TN * TD,
        TB * TD * 2 + TM * TN * TD * 2 + TM * 4 + TM * TB * TN * 2 + TM * TB * 4,
    )
    # the split: the select alone on the kernel's scores, the GEMM as the rest;
    # `torch.bmm` alone is the GEMM's own library yardstick
    select_ms = time_ms(torch, select_alone, 10)
    emit("kernel", name="topk_scores", s_frac_differ=frac_s, max_abs_err_s=ks_err,
         thresholds_bit_equal=True, select_alone_bit_equal=True, ms=row["ms"],
         was_ms=FIRST_DESIGN_MS["topk_scores"], scores_ms=row["ms"] - select_ms, select_ms=select_ms,
         bmm_ms=time_ms(torch, lambda: torch.bmm(xbm, dbt), 10), library_ms=row["library_ms"])
    rows.append(row)

    # K_d on the kernel's own scores and thresholds: c bit-equal, dxh within
    # 1 ulp, the loss sum within 1e-3
    c_k, dxh_k, lrec_k = kk.topk_decode(s_k, th_k, db, xb, scale)
    c_p, dxh_p, lrec_p = kk._topk_decode_plain(s_k, th_k, db, xb, scale)
    again = kk.topk_decode(s_k, th_k, db, xb, scale)
    torch.cuda.synchronize()
    check(torch.equal(c_k.view(torch.int16), c_p.view(torch.int16)), "K_d c differs from the plain version")
    check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip((c_k, dxh_k, lrec_k), again)),
          "K_d: two launches differ")
    del again
    frac_d, ulp_d = bf16_close(torch, dxh_k, dxh_p)
    check(ulp_d and frac_d < 1e-2, f"K_d dxh: {frac_d} differ, within 1 ulp: {ulp_d}")
    rel = float(((lrec_k - lrec_p).abs() / lrec_p.abs()).max())
    check(rel < 1e-3, f"K_d l_rec: max rel {rel}")
    kd_err = float((dxh_k.float() - dxh_p.float()).abs().max())
    del c_p, dxh_p
    nnz = int((c_k != 0).sum())
    l0 = (c_k != 0).sum(-1).float().mean(-1)
    row = dict(
        name="topk_decode", source=src, replaces="sparse_coding__tpu/ops/topk_kernel.py:144",
        max_abs_err=kd_err, shape=shape, variant="sparse decode (kept rows gathered)",
        ms=time_ms(torch, lambda: kk.topk_decode(s_k, th_k, db, xb, scale), 10),
        plain_ms=time_ms(torch, lambda: kk._topk_decode_plain(s_k, th_k, db, xb, scale), 3),
        library_ms=time_ms(torch, lambda: torch.bmm(c_k, db), 10),
    )
    row["bound_ms"], row["bound_by"] = bound(
        2 * nnz * TD,
        2 * TM * TB * TN * 2 + TM * TB * 4 + TM * TN * TD * 2 + TB * TD * 2 + TM * TB * TD * 2 + TM * 4,
    )
    emit("kernel", name="topk_decode", c_bit_equal=True, same_bits_twice=True, dxh_frac_differ=frac_d,
         max_abs_err_dxh=kd_err, lrec_max_rel=rel, c_nonzero_frac=nnz / c_k.numel(), mean_l0=l0.tolist(), k=TOPK_KS,
         ms=row["ms"], was_ms=FIRST_DESIGN_MS["topk_decode"])
    rows.append(row)
    del s_k, th_k

    # K2 and K3 at D 768, l1 = 0: the TopK path's backward, on the sparse
    # route it takes (the rows) and, timed beside it on the same inputs, the
    # dense route the tied paths take; both held against the plain versions
    l1b = torch.zeros(TM, device=dev)
    fwd = (xb, dxh_k, c_k, nrm)
    xbt = xb.expand(TM, TB, TD)
    ct = c_k.transpose(1, 2)
    library_ms = time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k), torch.bmm(ct, xbt)), 5)
    src_sparse = "sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd_sparse.cu"
    dense_ms = {}
    args, k2_err = check_k2(torch, tk, g, torch.float32, fwd, d_raw, l1b, "D=768 mu=f32 sparse", sparse=True)
    check_k2(torch, tk, g, torch.float32, fwd, d_raw, l1b, "D=768 mu=f32 dense")
    emit("kernel", name="tied_sae_bwd_adam_sparse", shape=shape, mu_dtype="torch.float32", max_abs_err_d_new=k2_err)
    held = args()
    row = dict(
        name="tied_sae_bwd_adam_sparse", source=src_sparse, replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255",
        max_abs_err=k2_err, shape=shape, variant="sparse route, stored code, mu f32, nu f32",
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held, sparse=True), 10),
        plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3), library_ms=library_ms,
    )
    dense_ms["k2_mu_f32_nu_f32"] = time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held), 5)
    sparse_ms = {"k2_mu_f32_nu_f32": row["ms"]}
    row["bound_ms"], row["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam", TM, TB, TN, TD, nnz))
    rows.append(row)
    del held
    for sparse in (True, False):
        check_k2(torch, tk, g, torch.bfloat16, fwd, d_raw, l1b, f"D=768 mu=bf16 sparse={sparse}", sparse=sparse)

    # the topk-capacity path's K2: int8 mu, bf16 nu, the stores seeded over
    # the JAX TopK step's 128-row dictionary tiles
    for sparse in (False, True):
        agree, cap_args, _ = check_epilogue(torch, tk, fwd, d_raw, l1b, "int8", "bfloat16", kk.SEED_TILE, g,
                                            f"K2 D=768 epilogue mu int8, nu bf16, sparse={sparse}", sparse=sparse)
        emit("kernel", name="tied_sae_bwd_adam_sparse" if sparse else "tied_sae_bwd_adam", shape=shape,
             variant="epilogue vs plain, mu int8, nu bf16", **agree)
    held = cap_args()
    row = dict(
        name="tied_sae_bwd_adam_sparse", source=src_sparse, replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255",
        variant="sparse route, stored code, mu int8, nu bf16", max_abs_err=agree["max_abs_err_d_new"], shape=shape,
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held, seed=3, seed_tile=kk.SEED_TILE, sparse=True), 10),
        plain_ms=time_ms(torch, lambda: _k2_plain(tk, *cap_args()), 3), library_ms=library_ms,
    )
    dense_ms["k2_mu_int8_nu_bf16"] = time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held, seed=3, seed_tile=kk.SEED_TILE), 5)
    sparse_ms["k2_mu_int8_nu_bf16"] = row["ms"]
    row["bound_ms"], row["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam", TM, TB, TN, TD, nnz, mu_bytes=1,
                                                             nu_bytes=2, mu_scaled=True))
    capacity_rows = [row]
    del held

    gp, gbp = tk._grads_plain(xb, dxh_k, c_k, nrm, db, l1b)
    k3 = {}
    for sparse in (True, False):
        gk, gbk = tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b, sparse=sparse)
        torch.cuda.synchronize()
        cos, rel = grads_close(torch, gk, gp, f"K3 D=768 g_enc sparse={sparse}")
        grads_close(torch, gbk, gbp, f"K3 D=768 g_bias sparse={sparse}")
        k3[sparse] = (cos, rel, float((gk - gp).abs().max()))
        del gk, gbk
        emit("kernel", name="tied_sae_bwd_grads_sparse" if sparse else "tied_sae_bwd_grads", shape=shape,
             cos=k3[sparse][0], max_rel=k3[sparse][1], max_abs_err=k3[sparse][2])
    del gp, gbp
    row = dict(
        name="tied_sae_bwd_grads_sparse", source=src_sparse, replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:201",
        max_abs_err=k3[True][2], shape=shape, variant="sparse route, gradient out",
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b, sparse=True), 10),
        plain_ms=time_ms(torch, lambda: tk._grads_plain(xb, dxh_k, c_k, nrm, db, l1b), 3), library_ms=library_ms,
    )
    dense_ms["k3"] = time_ms(torch, lambda: tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b), 5)
    sparse_ms["k3"] = row["ms"]
    row["bound_ms"], row["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_grads", TM, TB, TN, TD, nnz))
    rows.append(row)
    # the two routes side by side at this shape (the dense route's own rows
    # are the tied paths', where it runs)
    emit("kernel", name="tied_sae_bwd routes", shape=shape, code_nonzero_frac=nnz / c_k.numel(),
         sparse_ms=sparse_ms, dense_ms=dense_ms, library_ms=library_ms)
    return rows, capacity_rows


def tied_kernel_rows(torch, tk, g, shape):
    """K1, then K2 on its code (Adam with f32 moments, l1 `logspace(-4, -2,
    M)`), at ``shape`` = (M, B, N, D) on random inputs from ``g``, against
    their plain versions with the main paths' tolerances, timed beside the
    plain versions, the bound and the `bmm` library calls. Returns the two
    kernels-line rows."""
    dev = torch.device("cuda")
    M, B, N, D = shape
    shape = f"M={M},B={B},N={N},D={D}"
    d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((M, N), generator=g, device=dev) * 0.01
    scale = 2.0 / (B * D)
    c_k, dxh_k, lrec_k, ll1_k = tk.tied_sae_fwd(xb, db, bias, scale)
    c_p, ll1_p = tk._encode_plain(xb, db, bias)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c_k, scale)
    torch.cuda.synchronize()
    frac_c, ulp_c = bf16_close(torch, c_k, c_p)
    frac_d, ulp_d = bf16_close(torch, dxh_k, dxh_p)
    check(ulp_c and frac_c < 1e-3, f"K1 at {shape} c: {frac_c} differ, within 1 ulp: {ulp_c}")
    check(ulp_d and frac_d < 1e-2, f"K1 at {shape} dxh: {frac_d} differ, within 1 ulp: {ulp_d}")
    for what, a, b in (("l_rec", lrec_k, lrec_p), ("l_l1", ll1_k, ll1_p)):
        rel = float(((a - b).abs() / b.abs()).max())
        check(rel < 1e-3, f"K1 at {shape} {what}: max rel {rel}")
    nnz = int((c_k != 0).sum())
    xbm, dbt = xb.expand(M, B, D), db.transpose(1, 2)
    k1 = dict(name="tied_sae_fwd", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_fwd.cu",
              replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:191", shape=shape,
              max_abs_err=float((dxh_k.float() - dxh_p.float()).abs().max()),
              variant=("pipelined encode -> decode (TMA, wgmma), code stored" if D <= 512 else
                       "WMMA encode_kernel + decode_kernel, code stored"),
              ms=time_ms(torch, lambda: tk.tied_sae_fwd(xb, db, bias, scale), 20),
              plain_ms=time_ms(torch, lambda: tk._fwd_plain(xb, db, bias, scale), 5),
              library_ms=time_ms(torch, lambda: torch.bmm(torch.bmm(xbm, dbt), db), 20))
    k1["bound_ms"], k1["bound_by"] = bound(*tk.kernel_work("tied_sae_fwd", M, B, N, D, nnz))
    emit("kernel", name="tied_sae_fwd", shape=shape, c_frac_differ=frac_c, dxh_frac_differ=frac_d,
         c_nonzero_frac=nnz / c_k.numel(), ms=k1["ms"], bound_ms=k1["bound_ms"], plain_ms=k1["plain_ms"])
    del c_p, dxh_p
    l1b = torch.logspace(-4, -2, M, device=dev) / B
    args, k2_err = check_k2(torch, tk, g, torch.float32, (xb, dxh_k, c_k, nrm), d_raw, l1b, f"{shape} mu=f32")
    held = args()
    ct, xbt = c_k.transpose(1, 2), xb.expand(M, B, D)
    k2 = dict(name="tied_sae_bwd_adam", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd.cu",
              replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255", shape=shape, max_abs_err=k2_err,
              variant="stored code, mu f32, nu f32" + ("" if D <= 512 else ", WMMA bwd_kernel"),
              ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held), 10),
              plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3),
              library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k), torch.bmm(ct, xbt)), 10))
    k2["bound_ms"], k2["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam", M, B, N, D, nnz))
    emit("kernel", name="tied_sae_bwd_adam", shape=shape, max_abs_err_d_new=k2_err, ms=k2["ms"],
         bound_ms=k2["bound_ms"], plain_ms=k2["plain_ms"])
    return [k1, k2]


def phase_experiment_kernels(torch, tk, kk):
    """K1/K2 and K_s/K_d/the sparse K2 at the shapes the experiment catalog
    gives them (`EXP_TIED`, `EXP_TOPK`), against their plain versions with
    the tolerances of the main paths' checks, timed. Adam's moments are f32
    here (the builders' plain ``"adam"``). Returns the kernels-line rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    rows = tied_kernel_rows(torch, tk, g, EXP_TIED)

    def inputs(M, B, N, D):
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(torch.bfloat16)
        xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
        return d_raw, nrm, db, xb

    # TopK: K_s, K_d on its scores, the sparse K2 on K_d's code
    M, B, N, D = EXP_TOPK
    shape = f"M={M},B={B},N={N},D={D},k=1..151"
    d_raw, nrm, db, xb = inputs(M, B, N, D)
    k = torch.tensor([min(x, N) for x in EXP_KS], dtype=torch.int32, device=dev)
    scale = 2.0 / (B * D)
    src = "sparse_coding__tpu_torch/ops/csrc/topk_fwd.cu"
    s_k, th_k = kk.topk_scores(xb, db, k)
    s_p, _ = kk._topk_scores_plain(xb, db, k)
    th_p = kk._select_plain(s_k, k)
    torch.cuda.synchronize()
    frac_s, ulp_s = bf16_close(torch, s_k, s_p)
    check(ulp_s and frac_s < 1e-3, f"K_s at {shape} s: {frac_s} differ, within 1 ulp: {ulp_s}")
    check(torch.equal(th_k.view(torch.int32), th_p.view(torch.int32)),
          f"K_s at {shape}: thresholds differ from the plain select on the kernel's scores")
    xbm, dbt = xb.expand(M, B, D), db.transpose(1, 2)
    ks = dict(name="topk_scores", source=src, replaces="sparse_coding__tpu/ops/topk_kernel.py:98", shape=shape,
              max_abs_err=float((s_k.float() - s_p.float()).abs().max()),
              variant="TMA + wgmma scores, select on fp16 counts",
              ms=time_ms(torch, lambda: kk.topk_scores(xb, db, k), 10),
              plain_ms=time_ms(torch, lambda: kk._topk_scores_plain(xb, db, k), 3),
              library_ms=time_ms(torch, lambda: torch.topk(torch.bmm(xbm, dbt), int(k.max()), dim=-1), 10))
    ks["bound_ms"], ks["bound_by"] = bound(
        2 * M * B * N * D, B * D * 2 + M * N * D * 2 + M * 4 + M * B * N * 2 + M * B * 4)
    rows.append(ks)
    del s_p, th_p
    c_k, dxh_k, lrec_k = kk.topk_decode(s_k, th_k, db, xb, scale)
    c_p, dxh_p, lrec_p = kk._topk_decode_plain(s_k, th_k, db, xb, scale)
    torch.cuda.synchronize()
    check(torch.equal(c_k.view(torch.int16), c_p.view(torch.int16)), f"K_d at {shape}: c differs from the plain version")
    frac_d, ulp_d = bf16_close(torch, dxh_k, dxh_p)
    check(ulp_d and frac_d < 1e-2, f"K_d at {shape} dxh: {frac_d} differ, within 1 ulp: {ulp_d}")
    rel = float(((lrec_k - lrec_p).abs() / lrec_p.abs()).max())
    check(rel < 1e-3, f"K_d at {shape} l_rec: max rel {rel}")
    nnz = int((c_k != 0).sum())
    kd = dict(name="topk_decode", source=src, replaces="sparse_coding__tpu/ops/topk_kernel.py:144", shape=shape,
              max_abs_err=float((dxh_k.float() - dxh_p.float()).abs().max()),
              variant="sparse decode (kept rows gathered)",
              ms=time_ms(torch, lambda: kk.topk_decode(s_k, th_k, db, xb, scale), 10),
              plain_ms=time_ms(torch, lambda: kk._topk_decode_plain(s_k, th_k, db, xb, scale), 3),
              library_ms=time_ms(torch, lambda: torch.bmm(c_k, db), 10))
    kd["bound_ms"], kd["bound_by"] = bound(
        2 * nnz * D, 2 * M * B * N * 2 + M * B * 4 + M * N * D * 2 + B * D * 2 + M * B * D * 2 + M * 4)
    rows.append(kd)
    del c_p, dxh_p, s_k, th_k
    l1b = torch.zeros(M, device=dev)
    args, k2_err = check_k2(torch, tk, g, torch.float32, (xb, dxh_k, c_k, nrm), d_raw, l1b,
                            f"{shape} mu=f32 sparse", sparse=True)
    held = args()
    ct, xbt = c_k.transpose(1, 2), xb.expand(M, B, D)
    k2s = dict(name="tied_sae_bwd_adam_sparse", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd_sparse.cu",
               replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255", shape=shape, max_abs_err=k2_err,
               variant="sparse route, stored code, mu f32, nu f32",
               ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held, sparse=True), 10),
               plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3),
               library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k), torch.bmm(ct, xbt)), 10))
    k2s["bound_ms"], k2s["bound_by"] = bound(*tk.kernel_work("tied_sae_bwd_adam", M, B, N, D, nnz))
    rows.append(k2s)
    emit("kernel", name="topk path", shape=shape, s_frac_differ=frac_s, thresholds_bit_equal=True, c_bit_equal=True,
         dxh_frac_differ=frac_d, lrec_max_rel=rel, c_nonzero_frac=nnz / c_k.numel(),
         mean_l0=(c_k != 0).sum(-1).float().mean(-1).tolist(), max_abs_err_d_new=k2_err,
         ms={r["name"]: r["ms"] for r in (ks, kd, k2s)}, bound_ms={r["name"]: r["bound_ms"] for r in (ks, kd, k2s)})
    del held
    return rows


def fista_problem(torch, M: int, B: int, N: int, D: int, seed: int, l1_grid=FISTA_L1, shared_dict: bool = False):
    """A FISTA solve's inputs, drawn on the host from a seed and moved to the
    card: unit-norm dictionaries [M, N, D] (one for all members with
    ``shared_dict``), a batch [B, D] of sparse non-negative mixtures of
    member 0's rows plus noise, a non-negative warm start [M, B, N], and
    each member's l1 from ``l1_grid``."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((1 if shared_dict else M, N, D), generator=g)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).expand(M, N, D).contiguous()
    mask = torch.rand((B, N), generator=g) < 0.01
    codes = (0.5 + torch.rand((B, N), generator=g)) * mask
    x = codes @ d[0] + 0.01 * torch.randn((B, D), generator=g)
    c0 = torch.relu(torch.randn((M, B, N), generator=g)) * 0.05
    l1 = torch.tensor([l1_grid[m % len(l1_grid)] for m in range(M)])
    return x.cuda(), d.cuda(), c0.cuda(), l1.cuda()


def fista_agreement(torch, a_k, a_p, x, d):
    """K_f's codes against the plain loop's: (max |difference|, the share of
    entries whose support (> 0) differs, the relative difference of the
    residuals' squared norms ‖x − â·D‖²)."""
    diff = float((a_k - a_p).abs().max())
    flips = float(((a_k > 0) != (a_p > 0)).float().mean())
    rk, rp = [float(((x - torch.matmul(a, d)) ** 2).sum()) for a in (a_k, a_p)]
    return diff, flips, abs(rk - rp) / rp


def fista_kernel_row(torch, fk, tf, shape, line, seed, atol, reps, l1_grid):
    """K_f against its plain loop at ``shape`` (`phase_fista_kernels` says
    how it is held, timed and bounded): the kernels-line row."""
    src = "sparse_coding__tpu_torch/ops/csrc/fista.cu"
    M, B, N, D, iters = shape["M"], shape["B"], shape["N"], shape["D"], shape["iters"]
    check(fk.shapes_supported(B, N, D), f"K_f does not take {shape}")
    x, d, c0, l1 = fista_problem(torch, M, B, N, D, seed, l1_grid=l1_grid)
    eta = tf.default_eta(d)
    fk.reset_launches()
    a_k, it_k = fk.fista_cuda(x, d, eta, l1, c0, iters)
    with watching_plain_solves(torch, tf) as seen:
        a_p, _ = tf.fista_codes(x, d, eta, l1, c0, iters)
    torch.cuda.synchronize()
    yhat_nnz = int(seen["yhat_nonzeros"])
    check(fk.LAUNCHES["fista_solve"] == 1, f"K_f launches {fk.LAUNCHES}")
    check(it_k.tolist() == [iters] * M, f"K_f iterations {it_k.tolist()}")
    diff, flips, res_rel = fista_agreement(torch, a_k, a_p, x, d)
    check(diff <= atol and flips < 1e-3 and res_rel <= 1e-4,
          f"K_f at {shape}: max |diff| {diff}, support flips {flips}, ‖res‖² rel {res_rel}")
    label = f"M={M},B={B},N={N},D={D},iters={iters}"
    emit("fista_kernels", shape=label, max_abs_err=diff, bit_equal=bool(torch.equal(a_k, a_p)),
         support_flip_share=flips, res_sq_rel_diff=res_rel, code_nonzero_share=float((a_k > 0).float().mean()),
         yhat_nonzero_share=yhat_nnz / (M * B * N * iters), eta=eta.tolist())
    del a_p
    dt = d.transpose(1, 2)

    def library():
        for _ in range(iters):
            torch.bmm(torch.bmm(c0, d), dt)

    row = dict(
        name="fista_solve", source=src, replaces=f"sparse_coding__tpu/ops/fista_pallas.py:{line}",
        max_abs_err=diff, shape=label,
        variant="one cooperative launch, f32 FMA tiles, operands by cp.async into two stages",
        ms=time_ms(torch, lambda: fk.fista_cuda(x, d, eta, l1, c0, iters), reps, warmup=1),
        plain_ms=time_ms(torch, lambda: tf.fista_codes(x, d, eta, l1, c0, iters), reps, warmup=1),
        library_ms=time_ms(torch, library, reps, warmup=1),
    )
    # every iteration ran for every member (tol = 0): x − ŷ·D needs 2·D
    # operations per non-zero of ŷ (counted over this run's iterations),
    # res·Dᵀ 2·B·N·D; x, D and c0 read once, the codes written once. K_f's
    # route is float32 FMAs (its codes must stay the plain loop's), so
    # its bound is at the CUDA cores' rate; the same operations as three
    # TF32 tensor-core products each are printed beside it
    flops = 2 * D * yhat_nnz + 2 * B * N * D * iters * M
    nbytes = 4 * (B * D + M * N * D + 2 * M * B * N + 2 * M)
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    emit("fista_kernels", shape=label, variant=row["variant"], ms=row["ms"], was_ms=HOST_PACED_K_F_MS.get(label),
         bound_ms=row["bound_ms"], bound_route="float32 FMA, CUDA cores (67 TFLOP/s)",
         tensor_core_3xtf32_bound_ms=bound(3 * flops, nbytes, PEAK_TF32_FLOPS)[0], plain_ms=row["plain_ms"],
         library_ms=row["library_ms"])
    del x, d, c0, a_k
    torch.cuda.empty_cache()
    return row


def phase_fista_kernels(torch, fk, tf):
    """K_f against its plain loop on the same η, at the shape where the JAX
    package picks `_fista_kernel` (M 2, B 256, N 512, D 128, 100 iterations)
    at BASELINE config 3, where it picks `_fista_kernel_hbm_dict` (M 4,
    B 2048, N 2048, D 512, 500 iterations), and at the FISTA driver's
    BASELINE config 1 (M 8, B 1024, N 2048, D 512, 500 iterations, l1
    logspace(-4, -2, 8)), where it picks the same; each timed beside the plain loop
    and the library yardstick (the same 2·iterations f32 `bmm` calls without
    the epilogues, which the port never calls), and bounded by the work the
    data needs: x − ŷ·D over the non-zeros of ŷ that the plain loop met in
    its iterations (`watching_plain_solves`), res·Dᵀ dense. Tolerances: codes within
    1e-4 at 100 iterations (the JAX suite's pin for `_fista_kernel`) and 1e-3
    at 500 (should the two sum their 2048 and 512 products in
    another order, the iterations carry it; on an H100 with PyTorch 2.11's
    cuBLAS both sides came out bit-equal), support flips under 1e-3, ‖res‖²
    within 1e-4.
    Then one tol = 1e-3 solve at config 3's shape on a shared dictionary,
    with l1 30x config 3's grid so that every member can reach the
    tolerance within 500 iterations: each member stops early, at its own
    iteration, the same on both sides. Last, one short solve at N 2050,
    D 130 (rows of no whole float4s) and a ragged batch of 200, at tol 0
    and 1e-3: codes within 1e-4, the same iteration counts."""
    rows = [fista_kernel_row(torch, fk, tf, shape, line, seed, atol, reps, l1_grid)
            for shape, line, seed, atol, reps, l1_grid in (
                (FISTA_ROW8, 54, 11, 1e-4, 10, FISTA_L1),
                (dict(M=FM, B=FB, N=FN, D=FD, iters=FISTA_ITERS), 133, 12, 1e-3, 2, FISTA_L1),
                (dict(M=BLS["members"], B=BLS["batch"], N=BLS["n_dict"], D=BLS["width"], iters=FISTA_ITERS), 133,
                 15, 1e-3, 2, BLS_L1))]

    # the early exit: one largest code change per member over its whole batch
    x, d, _, l1 = fista_problem(torch, FM, FB, FN, FD, 13, l1_grid=[30 * a for a in FISTA_L1], shared_dict=True)
    eta = tf.default_eta(d)
    start = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start[0].record()
    a_k, it_k = fk.fista_cuda(x, d, eta, l1, None, FISTA_ITERS, tol=1e-3)
    start[1].record()
    a_p, it_p = tf.fista_codes(x, d, eta, l1, torch.zeros_like(a_k), FISTA_ITERS, tol=1e-3)
    torch.cuda.synchronize()
    diff, flips, res_rel = fista_agreement(torch, a_k, a_p, x, d)
    check(it_k.tolist() == it_p.tolist() and max(it_k.tolist()) < FISTA_ITERS,
          f"tol 1e-3: K_f stopped after {it_k.tolist()}, the plain loop after {it_p.tolist()}")
    check(diff <= 1e-3 and flips < 1e-3 and res_rel <= 1e-4, f"tol 1e-3: {diff}, {flips}, {res_rel}")
    emit("fista_kernels", shape=f"M={FM},B={FB},N={FN},D={FD},tol=1e-3", iterations=it_k.tolist(),
         plain_iterations=it_p.tolist(), max_abs_err=diff, support_flip_share=flips, res_sq_rel_diff=res_rel,
         ms=start[0].elapsed_time(start[1]))
    del x, d, a_k, a_p

    # N and D that are no multiples of 4 (each row's last float4 masked) and
    # a ragged batch: K_f against its plain loop at tol 0 and 1e-3
    M, B, N, D, iters = (FISTA_RAGGED[k] for k in ("M", "B", "N", "D", "iters"))
    check(fk.shapes_supported(B, N, D), f"K_f does not take {FISTA_RAGGED}")
    x, d, c0, l1 = fista_problem(torch, M, B, N, D, 14)
    eta = tf.default_eta(d)
    out = {}
    for tol in (0.0, 1e-3):
        fk.reset_launches()
        a_k, it_k = fk.fista_cuda(x, d, eta, l1, c0, iters, tol=tol)
        a_p, it_p = tf.fista_codes(x, d, eta, l1, c0, iters, tol=tol)
        torch.cuda.synchronize()
        diff, flips, res_rel = fista_agreement(torch, a_k, a_p, x, d)
        check(fk.LAUNCHES["fista_solve"] == 1 and it_k.tolist() == it_p.tolist()
              and diff <= 1e-4 and flips < 1e-3 and res_rel <= 1e-4,
              f"K_f at {FISTA_RAGGED}, tol {tol}: launches {fk.LAUNCHES}, iterations {it_k.tolist()} vs "
              f"{it_p.tolist()}, max |diff| {diff}, support flips {flips}, ‖res‖² rel {res_rel}")
        out[f"tol_{tol:g}"] = dict(iterations=it_k.tolist(), max_abs_err=diff, bit_equal=bool(torch.equal(a_k, a_p)),
                                   support_flip_share=flips, res_sq_rel_diff=res_rel)
    emit("fista_kernels", shape=f"M={M},B={B},N={N},D={D},iters={iters}", **out)
    return rows


def phase_fista_small_parity(torch, pkg, fk):
    """Three gradient steps, each followed by the FISTA decoder update (100
    iterations), at a small shape (D 128, N 512, batch 256, three members,
    the last masked) on the card (K_f) and on the CPU (its plain loop) from
    the same state: losses within 1e-5 relative; decoders within 2 lr per
    step (Adam's step may turn a near-zero gradient element either way)
    with a median difference under 1e-5; Hessian diagonals within 1e-4 of
    their largest entry; the masked member's decoder and Hessian diagonal
    unchanged on both sides; K_f launched once a step."""
    from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

    hp = [{"l1_alpha": a} for a in (1e-3, 3e-3, 1e-2)]
    kw = dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16", activation_size=128,
              n_dict_components=512)
    ens_c = pkg.build_ensemble(pkg.FunctionalFista, 3, hp, device="cpu", **kw)
    ens_g = pkg.Ensemble.from_state(ens_c.state_dict(), device="cuda")
    for ens in (ens_c, ens_g):
        ens.set_update_mask([1.0, 1.0, 0.0])
    frozen = [ens_c.state.params["decoder"][2].clone(), ens_c.state.buffers["hessian_diag"][2].clone()]
    update = make_fista_decoder_update(num_iter=100)
    x = torch.randn((3, 256, 128), generator=torch.Generator().manual_seed(6))
    fk.reset_launches()
    worst = {"loss_rel": 0.0, "decoder": 0.0, "decoder_median": 0.0, "hessian_rel": 0.0}
    for k in range(3):
        lc, ac = ens_c.step_batch(x[k])
        ens_c.state = update(ens_c.state, x[k], ac["c"])
        lg, ag = ens_g.step_batch(x[k].cuda())
        ens_g.state = update(ens_g.state, x[k].cuda(), ag["c"])
        dc, dg = ens_c.state.params["decoder"], ens_g.state.params["decoder"].cpu()
        hc, hg = ens_c.state.buffers["hessian_diag"], ens_g.state.buffers["hessian_diag"].cpu()
        diff = (dg - dc).abs()
        worst["loss_rel"] = max(worst["loss_rel"], float(((lg["loss"].cpu() - lc["loss"]) / lc["loss"]).abs().max()))
        worst["decoder"] = max(worst["decoder"], float(diff.max()))
        worst["decoder_median"] = max(worst["decoder_median"], float(diff.median()))
        worst["hessian_rel"] = max(worst["hessian_rel"], float((hg - hc).abs().max() / hc.abs().max()))
        check(worst["loss_rel"] <= 1e-5 and worst["decoder"] <= 2 * LR * (k + 1) and worst["decoder_median"] <= 1e-5
              and worst["hessian_rel"] <= 1e-4, f"fista small parity after {k + 1} steps: {worst}")
        for side, st in (("cpu", ens_c.state), ("cuda", ens_g.state)):
            check(torch.equal(st.params["decoder"][2].cpu(), frozen[0])
                  and torch.equal(st.buffers["hessian_diag"][2].cpu(), frozen[1]), f"{side}: masked member moved")
    check(fk.LAUNCHES["fista_solve"] == 3, f"K_f launches {fk.LAUNCHES}")
    emit("fista_small_parity", steps=3, fista_iters=100, masked_member=2, **{f"max_{k}": v for k, v in worst.items()})


@contextlib.contextmanager
def watching_plain_solves(torch, tf):
    """Watches every run of the plain FISTA loop (`run_fista_iterations`,
    the scaffold of both `fista` and K_f's plain version) inside the block:
    ``calls`` counts them; ``yhat_nonzeros``, a device counter read after
    the block, sums over their iterations the non-zero entries of ŷ that
    each iteration's first product x − ŷ·D multiplies."""
    seen = {"calls": 0, "yhat_nonzeros": torch.zeros((), dtype=torch.int64, device="cuda")}
    real = tf.run_fista_iterations

    def watched(update, c0, *a, **kw):
        seen["calls"] += 1

        def counting(ahat, ahat_y, i):
            seen["yhat_nonzeros"].add_(torch.count_nonzero(ahat_y))
            return update(ahat, ahat_y, i)

        return real(counting, c0, *a, **kw)

    tf.run_fista_iterations = watched
    try:
        yield seen
    finally:
        tf.run_fista_iterations = real


def phase_fista_train(torch, pkg, cfg):
    """The FISTA path's main run: chunk store → ensemble_train_loop (the
    autograd gradient step, then the decoder update through K_f, every
    batch) → one masked step. K_f solves once a step; no other kernel and no
    plain solve runs."""
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop

    sig, members, batch = pkg.FunctionalFista, cfg["members"], cfg["batch"]
    tmp, gen, store, eval_batch = synthetic_store(torch, cfg)
    ens = pkg.build_ensemble(sig, 0, cfg["hparams"], **cfg["build"])
    check(not ens.fused and ens.fused_adam is None, "FunctionalFista took a fused path")
    check(fk.shapes_supported(batch, cfg["build"]["n_dict_components"], cfg["width"]), "K_f refuses config 3")

    def eval_loss():
        with torch.no_grad():
            return sig.loss(ens.state.params, ens.state.buffers, eval_batch[:batch])[0]

    def counts():
        return {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}

    loss0 = eval_loss()
    for mod in (tk, kk, fk):
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, last = 0, None
    with watching_plain_solves(torch, tf) as plain:
        for i, chunk in enumerate(store.iter_chunks([0, 1])):
            last = ensemble_train_loop(ens, chunk, batch, key=i, fista_iters=FISTA_ITERS)
            steps += chunk.shape[0] // batch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop_launches = counts()
        want = {name: 0 for name in loop_launches}
        want["fista_solve"] = steps
        check(loop_launches == want, f"launches {loop_launches} after {steps} steps, want {want}")
        # one masked step through the loop: the last member's gradient step
        # and decoder update both leave it as it was
        frozen = [ens.state.params["decoder"][-1].clone(), ens.state.buffers["hessian_diag"][-1].clone()]
        ens.set_update_mask([1.0] * (members - 1) + [0.0])
        masked = ensemble_train_loop(ens, eval_batch[batch:2 * batch], batch, key=9, fista_iters=FISTA_ITERS,
                                     dead_check=False)
        torch.cuda.synchronize()
    launches = counts()
    want["fista_solve"] += 1
    check(launches == want, f"launches {launches} after {steps} + 1 masked steps, want {want}")
    check(plain["calls"] == 0, f"{plain['calls']} plain FISTA solves ran on the card")
    check(torch.equal(frozen[0], ens.state.params["decoder"][-1])
          and torch.equal(frozen[1], ens.state.buffers["hessian_diag"][-1]), "masked member moved")
    loss1 = eval_loss()
    finite = all(bool(torch.isfinite(v).all()) for v in (*last.values(), *masked.values(), loss1))
    check(finite, "non-finite loss")
    check(bool((ens.state.buffers["hessian_diag"][:-1] > 0).any()), "the Hessian EMA never moved")
    emit(
        "fista_train", path=cfg["path"], steps=steps, batch=batch, members=members, fista_iters=FISTA_ITERS,
        store_dtype=cfg["store_dtype"], wall_s=wall, activations_per_s=steps * batch * members / wall,
        loss_before=loss0.tolist(), loss_after=loss1.tolist(), last_step_loss=last["loss"].tolist(),
        launches_after_loop=loop_launches, launches=launches, plain_solves=plain["calls"],
    )
    return ens, gen, eval_batch, tmp, launches


def phase_fista_step(torch, pkg, cfg, reps: int = 3):
    """One resident FISTA step split into its gradient step and its decoder
    update, each by CUDA events, beside the host's time to enqueue each; K_f
    timed by events around its call inside the same decoder updates; the
    peak device memory of a step with the state resident (less what was
    allocated before the ensemble was built)."""
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ens = pkg.build_ensemble(pkg.FunctionalFista, 1, cfg["hparams"], **cfg["build"])
    update = make_fista_decoder_update(FISTA_ITERS)
    x = torch.randn((cfg["batch"], cfg["width"]), device="cuda")
    _, aux = ens.step_batch(x)
    ens.state = update(ens.state, x, aux["c"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    solves = []  # (start, end) events around each K_f call of the timed steps
    real = fk.fista_cuda

    def timed_fista_cuda(*a, **kw):
        pair = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pair[0].record()
        out = real(*a, **kw)
        pair[1].record()
        solves.append(pair)
        return out

    grad_ms = upd_ms = enq_grad = enq_upd = 0.0
    fk.fista_cuda = timed_fista_cuda  # `fista_solve` looks it up at each call
    try:
        for _ in range(reps):
            ev[0].record()
            t0 = time.perf_counter()
            _, aux = ens.step_batch(x)
            t1 = time.perf_counter()
            ev[1].record()
            ens.state = update(ens.state, x, aux["c"])
            t2 = time.perf_counter()
            ev[2].record()
            ev[2].synchronize()
            grad_ms += ev[0].elapsed_time(ev[1])
            upd_ms += ev[1].elapsed_time(ev[2])
            enq_grad += (t1 - t0) * 1e3
            enq_upd += (t2 - t1) * 1e3
    finally:
        fk.fista_cuda = real
    check(len(solves) == reps, f"{len(solves)} K_f calls in {reps} steps")
    solve_ms = sum(a.elapsed_time(b) for a, b in solves) / reps
    peak = torch.cuda.max_memory_allocated() - before
    step_ms = (grad_ms + upd_ms) / reps
    emit("fista_step", path=cfg["path"], steps=reps, ms_per_step=step_ms, gradient_step_ms=grad_ms / reps,
         decoder_update_ms=upd_ms / reps, fista_solve_ms=solve_ms, fista_solve_share=solve_ms / step_ms,
         host_enqueue_gradient_step_ms=enq_grad / reps, host_enqueue_decoder_update_ms=enq_upd / reps,
         activations_per_s=cfg["batch"] * ens.n_models / step_ms * 1e3, step_peak_bytes=peak)


def phase_health_graph(torch, pkg, tf, steps: int = 8):
    """The health pack and the feature sketch on the tied path's full width
    (M 8, B 2048, N 4096, D 512, bf16): the packs turn the fused kernels off
    (JAX's rule), so the step is the autograd one, captured with the packs
    into its CUDA graph. ``steps`` graph replays (`step_scan`, after a call
    that captured the step) and ``steps`` eager steps on a twin from the
    same state give the same bits: losses, every ``health_*`` metric,
    params, moments, the firing EMA and the sketch; a twin without the
    packs (unfused too) gives the packs' twin's losses and codes bit for bit
    (observation only); the sketch counts ``steps`` × 2048 rows a member;
    the replays launch no K1, K2 or K3 (`run_counted`). Then the
    graph step timed (CUDA events) with the packs and, in the same run,
    without them on the same unfused route: what the packs cost there; and
    the same for the FISTA driver's eager gradient step at BASELINE config
    1 (f32 autograd, M 8, B 1024, N 2048, D 512)."""
    from _torch_moments import state_differences
    from sparse_coding__tpu_torch.telemetry.feature_stats import FEATURE_STATS_KEYS
    from sparse_coding__tpu_torch.telemetry.health import FIRE_EMA_KEY

    build = dict(TIED["build"], health=True, feature_stats=True)
    with watching_plain_solves(torch, tf) as plain:
        a = pkg.build_ensemble(pkg.FunctionalTiedSAE, 7, TIED["hparams"], fused=True, **build)
        check(a.fused is False and a.fused_adam is None, f"packs on, fused {a.fused}")
        b = pkg.Ensemble.from_state(a.state_dict(), sig=a.sig, device="cuda")
        bare = pkg.build_ensemble(pkg.FunctionalTiedSAE, 7, TIED["hparams"], fused=False, **TIED["build"])
        g = torch.Generator(device="cuda").manual_seed(8)
        xs = torch.randn((steps + 1, B, D), generator=g, device="cuda")
        a.step_scan(xs[:1])
        lb0, ab0 = b.step_batch(xs[0])
        ln0, an0 = bare.step_batch(xs[0])
        check(torch.equal(ab0["c"], an0["c"]) and all(torch.equal(lb0[k], ln0[k]) for k in ln0),
              "the packs changed the step's losses or codes")
        la, ran, short = run_counted(torch, lambda: a.step_scan(xs[1:]))
        lb = []
        for x in xs[1:]:
            lbk, abk = b.step_batch(x)
            lnk, ank = bare.step_batch(x)
            check(torch.equal(abk["c"], ank["c"]) and all(torch.equal(lbk[k], lnk[k]) for k in lnk),
                  "the packs changed the step's losses or codes")
            lb.append(lbk)
        torch.cuda.synchronize()
    check(plain["calls"] == 0, f"{plain['calls']} plain FISTA solves ran")
    check(sum(ran.values()) == 0, f"fused kernels ran under the packs: {ran}")
    check(a.captures == 1, f"{a.captures} captures")
    health = sorted(k for k in lb[0] if k.startswith("health_"))
    check(health == ["health_dead_frac", "health_dict_norm", "health_grad_norm", "health_nonfinite"], f"{health}")
    for k in lb[0]:
        check(torch.equal(la[k], torch.stack([l[k] for l in lb])), f"health graph: {k} differs from eager")
    diff = state_differences(a.state, b.state)
    check(diff == [], f"health graph: state differs from eager at {diff}")
    rows = a.state.buffers["featstat_rows"].tolist()
    check(rows == [float((steps + 1) * B)] * M, f"featstat_rows {rows}")
    check(all(bool(torch.isfinite(la[k]).all()) for k in health), "non-finite health metric")
    # the graph step with and without the packs (both unfused), in turns
    reps = 10
    xr = xs[1:].repeat(2, 1, 1)[:reps]
    bare.step_scan(xr[:1])
    ms = {}
    for name, ens in (("packs", a), ("no_packs", bare), ("packs", a), ("no_packs", bare)):
        ms.setdefault(name, []).append(time_ms(torch, lambda: ens.step_scan(xr), 1, warmup=1) / reps)
    fire_ema_mean, fused, captures = float(a.state.buffers[FIRE_EMA_KEY].mean()), a.fused, a.captures
    del a, b, bare
    torch.cuda.empty_cache()
    # the FISTA driver's gradient step (BASELINE config 1, f32 autograd,
    # eager as the driver runs it) with and without the packs, in turns
    kw = dict(optimizer_kwargs={"learning_rate": LR}, activation_size=BLS["width"], n_dict_components=BLS["n_dict"])
    hp = [{"l1_alpha": a} for a in BLS_L1]
    twins = {"packs": pkg.build_ensemble(pkg.FunctionalFista, 0, hp, health=True, feature_stats=True, **kw),
             "no_packs": pkg.build_ensemble(pkg.FunctionalFista, 0, hp, **kw)}
    xf = torch.randn((BLS["batch"], BLS["width"]), generator=g, device="cuda")
    fista_ms = {}
    for name in ("packs", "no_packs", "packs", "no_packs"):
        fista_ms.setdefault(name, []).append(time_ms(torch, lambda: twins[name].step_batch(xf), 10, warmup=2))
    emit("health_graph", path="tied_l1_sweep health + feature stats", members=M, batch=B, steps=steps,
         fused=fused, captures=captures, launches_in_replays=ran, trace_short=short, bit_equal=True,
         health_metrics=health, sketch_keys=list(FEATURE_STATS_KEYS), featstat_rows=rows,
         fire_ema_mean=fire_ema_mean, dead_frac=la["health_dead_frac"][-1].tolist(), graph_step_ms=ms,
         fista_config1_gradient_step_ms=fista_ms, plain_solves=plain["calls"])
    del twins
    torch.cuda.empty_cache()


def bls_store(torch, root: Path) -> Path:
    """The driver's store: 2 fp16 chunks of 4,096 rows of width 512 from the
    tied path's synthetic generator, built on the card."""
    import numpy as np

    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    gen = RandomDatasetGenerator(activation_dim=BLS["width"], batch_size=BLS["rows_per_chunk"], correlated=False,
                                 **dict(TIED["data"], key=4))
    store = generate_synthetic_chunks(gen, root / "bls_store", BLS["chunks"],
                                      chunk_size_gb=BLS["rows_per_chunk"] * BLS["width"] * 2 / 1024**3,
                                      dtype=np.float16)
    check(store.indices() == list(range(BLS["chunks"])), f"store {store.indices()}")
    return root / "bls_store"


def bls_run(store: Path, out: Path, resume: bool = False):
    """The FISTA driver at BASELINE config 1 (its own defaults at width 512),
    2 epochs, a checkpoint at every chunk."""
    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

    return basic_l1_sweep(str(store), str(out), activation_width=BLS["width"], batch_size=BLS["batch"],
                          n_epochs=BLS["epochs"], checkpoint_every=1, resume=resume)


def bls_worker(argv) -> int:
    """``chip_smoke.py --bls-worker <store> <out> [--resume]``: the driver as a
    process of its own (``SC_FAULT`` from the environment), under the watch
    for plain FISTA solves: any one fails the process."""
    import torch

    from sparse_coding__tpu_torch.models import fista as tf

    with watching_plain_solves(torch, tf) as plain:
        try:
            bls_run(Path(argv[0]), Path(argv[1]), resume="--resume" in argv[2:])
        finally:
            check(plain["calls"] == 0, f"{plain['calls']} plain FISTA solves ran in the driver")
    return 0


def phase_basic_l1_sweep_train(torch, tf, root: Path):
    """The FISTA driver end to end (BASELINE config 1: 8 members, width 512,
    dictionary 2048, batch 1024, 500 iterations, health + feature stats on)
    over a store built on the card, 2 epochs = 16 steps, a checkpoint at
    every chunk (`run_counted`): K_f solves once a step, no other
    hand-written kernel runs and no plain solve. Checks the exports of both
    epochs; one feature snapshot per chunk boundary (4: the tail flush finds
    an empty window); finite ``health_*`` metrics in the metrics JSONL;
    every member's loss falling from its first step to its last; the
    exports' FVU (finite); no member flagged non-finite by the anomaly guard
    (its other detections are printed); the device-memory gauges
    (``hbm.d0.*``) in the last ``snapshot`` record. Returns (the run's K_f
    launches, its output dir)."""
    import numpy as np

    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib

    store = bls_store(torch, root)
    out = root / "bls_a"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        lds = bls_run(store, out)
        torch.cuda.synchronize()
        return lds, time.perf_counter() - t0

    with watching_plain_solves(torch, tf) as plain:
        (lds, wall), launches, short = run_counted(torch, run)
    peak = torch.cuda.max_memory_allocated() - before
    steps = BLS["epochs"] * BLS["chunks"] * BLS["rows_per_chunk"] // BLS["batch"]
    want = {k: 0 for k in launches}
    want["fista_solve"] = steps
    check(launches == want, f"driver launches {launches} after {steps} steps, want {want}")
    check(plain["calls"] == 0, f"{plain['calls']} plain FISTA solves ran in the driver")
    for e in range(BLS["epochs"]):
        check((out / f"epoch_{e}" / "learned_dicts.pkl").exists(), f"epoch_{e} export missing")
    snaps = sorted(p.name for p in out.glob("feature_stats.train*.npz"))
    check(len(snaps) == BLS["epochs"] * BLS["chunks"], f"feature snapshots {snaps}")
    recs = [json.loads(line) for line in open(out / "basic_l1_sweep_metrics.jsonl")]
    health, losses = {}, {}
    for r in recs:
        if r["metric"].startswith("health_"):
            health.setdefault(r["metric"], []).append(r["value"])
        if r["metric"] == "loss":
            losses.setdefault(r["series"], []).append(r["value"])
    check(len(losses) == BLS["members"] and all(v[-1] < v[0] for v in losses.values()),
          f"a member's loss did not fall: {[(v[0], v[-1]) for v in losses.values()]}")
    check(sorted(health) == ["health_dead_frac", "health_dict_norm", "health_grad_norm", "health_nonfinite"]
          and all(math.isfinite(v) for vals in health.values() for v in vals)
          and all(len(v) == steps * BLS["members"] for v in health.values()), "health metrics in the JSONL")
    events = read_events(out / "events.jsonl")
    check([e["status"] for e in events if e["event"] == "run_end"] == ["ok"], "run_end")
    anomalies = [(e["kind"], e["step"], e["models"]) for e in events if e["event"] == "anomaly"]
    gauges = [e for e in events if e["event"] == "snapshot"][-1]["gauges"]
    hbm = {k: v for k, v in gauges.items() if k.startswith("hbm.")}
    check(hbm.get("hbm.d0.peak_bytes_in_use", 0) > 0 and hbm.get("hbm.d0.bytes_limit", 0) > 0, f"hbm gauges {hbm}")
    check(not [a for a in anomalies if a[0] == "nonfinite"], f"non-finite members: {anomalies}")
    loaded = ckpt_lib.load_learned_dicts(out / "epoch_1" / "learned_dicts.pkl", verify=True)
    sample = torch.from_numpy(np.load(store / "0.npy")[:4096]).cuda().float()
    fvu = [m["fvu"] for m in evaluate_dicts([ld for ld, _ in loaded], sample)]
    check(len(loaded) == len(lds) == BLS["members"] and all(math.isfinite(v) for v in fvu), f"driver FVU {fvu}")
    end = events[-1]
    emit("basic_l1_sweep_train", config="BASELINE config 1", members=BLS["members"], width=BLS["width"],
         n_dict=BLS["n_dict"], batch=BLS["batch"], fista_iters=FISTA_ITERS, chunks=BLS["chunks"],
         rows_per_chunk=BLS["rows_per_chunk"], epochs=BLS["epochs"], steps=steps, launches=launches,
         trace_short=short, wall_s=wall,
         activations_per_s=steps * BLS["batch"] * BLS["members"] / wall,
         span_seconds={c: span_seconds(events, c) for c in ("step", "data_wait", "checkpoint", "feature_flush")},
         step_span_activations_per_s=steps * BLS["batch"] * BLS["members"] / span_seconds(events, "step"),
         driver_peak_bytes=peak, hbm_gauges=hbm, timer=end.get("timer"), snapshots=snaps, fvu=fvu,
         loss_first_last=[(v[0], v[-1]) for v in losses.values()],
         dead_frac_last=health["health_dead_frac"][-BLS["members"]:], anomalies=anomalies,
         plain_solves=plain["calls"])
    return launches["fista_solve"], out


def phase_basic_l1_sweep_resume(torch, root: Path, control: Path):
    """The same driver run SIGTERMed after epoch 1's first chunk in a process
    of its own (exit 75, ``ckpt_2`` committed), then resumed in another
    (exit 0): both epochs' exports are the uninterrupted run's bits, and so
    are the resumed run's firing EMA (the last checkpoint's) and every
    feature snapshot (the sketch continues from the checkpoint's)."""
    import numpy as np

    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.telemetry.feature_stats import load_run_snapshots
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib

    store, out = root / "bls_store", root / "bls_b"

    def worker(*extra, fault=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
        if fault:
            env["SC_FAULT"] = fault
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--bls-worker", str(store), str(out),
                               *extra], env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - t

    killed, killed_s = worker(fault="sigterm:chunk=0:epoch=1")
    check(killed.returncode == 75, f"preempted driver exited {killed.returncode}: {killed.stderr[-3000:]}")
    check(ckpt_lib.latest_checkpoint(out).name == "ckpt_2", "ckpt_2 is not the newest checkpoint")
    resumed, resumed_s = worker("--resume")
    check(resumed.returncode == 0, f"resumed driver exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    n = 0
    for e in range(BLS["epochs"]):
        got = ckpt_lib.load_learned_dicts(out / f"epoch_{e}" / "learned_dicts.pkl", verify=True, device="cpu")
        ref = ckpt_lib.load_learned_dicts(control / f"epoch_{e}" / "learned_dicts.pkl", verify=True, device="cpu")
        check(len(got) == len(ref) == BLS["members"], "resumed export length")
        for (g, hg), (r, hr) in zip(got, ref):
            check(hg == hr, f"hyperparams {hg} != {hr}")
            for f in ("encoder", "encoder_bias", "decoder"):
                check(torch.equal(getattr(g, f), getattr(r, f)), f"epoch {e}: resumed {f} differs")
                n += 1
    ema = [ckpt_lib.restore_ensemble_checkpoint(d / "ckpt_3")["ensembles"]["ensemble"]["state"]
           .buffers["health_fire_ema"] for d in (out, control)]
    check(torch.equal(ema[0], ema[1]), "the resumed firing EMA differs from the uninterrupted run's")
    snaps = [load_run_snapshots(d) for d in (out, control)]
    check([s.gen for s in snaps[0]] == [s.gen for s in snaps[1]] and len(snaps[0]) == 4, "snapshot generations")
    for sa, sb in zip(*snaps):
        for f in ("rows", "fire", "sum", "sumsq", "max", "hist"):
            check(np.array_equal(getattr(sa, f), getattr(sb, f)), f"snapshot {sa.gen}: {f} differs")
    events = read_events(out / "events.jsonl")
    statuses = [e["status"] for e in events if e["event"] == "run_end"]
    check(statuses == ["preempted", "ok"], f"run_end statuses {statuses}")
    emit("basic_l1_sweep_resume", fault="sigterm:chunk=0:epoch=1", preempted_exit=killed.returncode,
         preempted_s=killed_s, resumed_exit=resumed.returncode, resumed_s=resumed_s, checkpoint="ckpt_2",
         run_end=statuses, bit_equal_arrays=n, fire_ema_bit_equal=True, snapshots_bit_equal=len(snaps[0]),
         resume_cursor=next(e for e in events if e["event"] == "resume")["cursor"])


# the fleet scheduler (ROADMAP A9's fleet group) over the FISTA driver: BLS_L1
# packed into 2 items of 4 members from bls_a's watermark, each item 1 epoch
# over bls_store's 2 chunks with a checkpoint at every chunk (8 steps of K_f at
# M 4, B 1024, N 2048, D 512); worker w0 alone first, under three faults (the
# kill's every=2 counts the chunk-1 tops w0 passes, so it lands on w0's second
# item, after that item's ckpt_0): the torn first save of
# its first item (released for another attempt), a transient chunk read
# (retried in place) and a SIGKILL at the top of its second item's chunk 1;
# w1 starts once w0 holds its second item, and resumes it from ckpt_0 after
# the scheduler (this process) reaps the dead lease
FLEET = dict(groups=2, reserve=0.2, lease_seconds=6.0, poll=0.2, idle_exit=180.0, tick=0.25, deadline_s=420.0,
             w0_fault="kill:chunk_loop:chunk=1:every=2:times=1;torn_checkpoint;io_error:chunk_read:times=1",
             sync_backoff="0.1", serve_rows=1024)


def fleet_counts_path(fleet: Path, wid: str) -> Path:
    return fleet / f".smoke_counts_{wid}.json"


def fleet_worker(argv) -> int:
    """``chip_smoke.py --fleet-worker <fleet> <worker_id>``: the port's fleet
    worker CLI (`sparse_coding__tpu_torch.fleet.worker.main`, on the card) as a
    process of its own (``SC_FAULT`` from the environment), under the watch
    for plain FISTA solves. The wrappers' launch counts (0 at the start of
    this process) and the plain solves are written to a file at every
    checkpoint commit and chunk top, the sites its faults fire at, and at
    the end, so a SIGKILLed worker leaves the counts of everything it
    launched. Any plain solve fails the process."""
    import torch

    from sparse_coding__tpu_torch.fleet import worker as worker_mod
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.train import basic_l1_sweep as bls_mod
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_mod

    fleet, wid = Path(argv[0]), argv[1]
    for mod in (tk, kk, fk):
        mod.reset_launches()
    with watching_plain_solves(torch, tf) as plain:
        def record():
            counts = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
            tmp = fleet_counts_path(fleet, wid).with_suffix(".tmp")
            tmp.write_text(json.dumps({"launches": counts, "plain_solves": plain["calls"]}))
            os.replace(tmp, fleet_counts_path(fleet, wid))

        patched = {}
        for mod in (ckpt_mod, bls_mod):
            real = patched[mod] = mod.fault_point

            def recording(site, _real=real, **ctx):
                if site in ("checkpoint_commit", "chunk_loop"):
                    record()
                _real(site, **ctx)

            mod.fault_point = recording
        try:
            rc = worker_mod.main([str(fleet), "--worker-id", wid, "--lease-seconds", str(FLEET["lease_seconds"]),
                                  "--poll", str(FLEET["poll"]), "--idle-exit", str(FLEET["idle_exit"])])
        finally:
            for mod, real in patched.items():
                mod.fault_point = real
            record()
        check(plain["calls"] == 0, f"{plain['calls']} plain FISTA solves ran in fleet worker {wid}")
    return rc


def local_host_runner(cmd):
    """`utils.sync`'s transport for a "remote" on this machine's own
    filesystem, host ``localhost``: the listing ``ssh`` runs its command in
    a local shell, rsync runs here without its ssh transport (the package's
    python mirror where rsync is not installed). No network is touched."""
    from sparse_coding__tpu_torch.utils import sync

    if cmd[0] == "ssh":
        return subprocess.run(["bash", "-c", cmd[-1]], capture_output=True, text=True, timeout=60)
    check(cmd[0] == "rsync", f"unexpected transfer tool {cmd}")
    args = list(cmd)
    if "-e" in args:
        i = args.index("-e")
        del args[i:i + 2]
    args[-2:] = [p.split("localhost:", 1)[-1] for p in args[-2:]]
    if shutil.which("rsync"):
        return subprocess.run(args, capture_output=True, text=True, timeout=120)
    sync._local_sync(args[-2], args[-1], None, None, "--delete" in args)
    return subprocess.CompletedProcess(args, 0, "local python mirror", "")


def phase_fleet(torch, tf, root: Path, watermark_run: Path):
    """The fleet path on the card (ROADMAP A9's fleet group): `pack_members`
    sizes 2 groups of 4 from the per-member bytes ``bls_a`` recorded
    (`member_bytes_from_run`), `build_sweep_items` submits them as
    `basic_l1_sweep` items over ``bls_store`` (BASELINE config 1's width, 1
    epoch, a checkpoint at every chunk), and two worker processes on the one
    card (``--fleet-worker``: the port's worker CLI) drain the queue while
    this process ticks the `FleetScheduler` with a 6 s lease. Worker w0
    (`FLEET`'s faults): its first item's first checkpoint is torn (the item
    is released and w0 runs it again from the start), its first chunk read
    fails once (retried in place: ``io.retry``), and it is SIGKILLed at its
    second item's chunk 1, after that item's ``ckpt_0``; the scheduler reaps
    the dead lease and w1 resumes the item from ``ckpt_0``. Checks: 8
    members done, 0 lost; the killed item's lineage ``["lease_expired",
    "done"]`` resumed from ``ckpt_0``; every run dir verifies
    (`verify_export`); each group's ``epoch_0`` export bit-equal to an
    uninterrupted control run of it in this process; K_f launches across the
    workers equal to the steps their run dirs record and the controls' to
    theirs, no other kernel and no plain solve anywhere; the fleet report,
    the monitor's fleet view, the goodput gap and the tower's gauges; a run
    dir served by `DictRegistry` (its dicts' encode bit-equal to the loaded
    export's); the runs pushed to a local "remote" and pulled back by
    `utils.sync`, verified. Returns the workers' K_f launches."""
    import numpy as np

    from sparse_coding__tpu_torch.fleet import (
        FleetScheduler, WorkQueue, build_sweep_items, load_fleet, member_bytes_from_run, pack_members,
        render_fleet_markdown, verify_export,
    )
    from sparse_coding__tpu_torch.monitor import main as monitor_main
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.serve.registry import DictRegistry
    from sparse_coding__tpu_torch.telemetry import RunTelemetry, read_events
    from sparse_coding__tpu_torch.telemetry.goodput import build_ledger, fleet_reassignment_gaps
    from sparse_coding__tpu_torch.telemetry.tower import _fleet_gauges
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep
    from sparse_coding__tpu_torch.utils.manifest import sha256_file
    from sparse_coding__tpu_torch.utils.sync import pull_latest_outputs, push_outputs

    t_phase = time.perf_counter()
    store, fleet = root / "bls_store", root / "fleet"
    members = len(BLS_L1)
    per_member = member_bytes_from_run(watermark_run, members)
    check(per_member is not None and per_member > 0, f"no device-memory watermark in {watermark_run}")
    group = members // FLEET["groups"]
    # the budget that holds `group` members and not one more, after the reserve
    budget = (group + 0.5) * per_member / (1.0 - FLEET["reserve"])
    groups = pack_members(BLS_L1, hbm_budget_bytes=budget, reserve_fraction=FLEET["reserve"],
                          watermark_run_dir=watermark_run, watermark_members=members)
    check([len(g) for g in groups] == [group] * FLEET["groups"], f"packed {[len(g) for g in groups]}")
    base = dict(dataset_folder=str(store), activation_width=BLS["width"], batch_size=BLS["batch"], n_epochs=1,
                checkpoint_every=1)
    q = WorkQueue(fleet)
    items = [it["item"] for it in build_sweep_items(q, groups, base)]
    first, second = items

    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    env["SC_SYNC_BACKOFF"] = FLEET["sync_backoff"]
    logs, procs = {}, {}

    def spawn(wid, fault=None):
        logs[wid] = open(fleet / f".smoke_{wid}.log", "w")
        procs[wid] = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--fleet-worker", str(fleet), wid],
                                      env={**env, **({"SC_FAULT": fault} if fault else {})}, cwd=REPO,
                                      stdout=logs[wid], stderr=subprocess.STDOUT)

    def tail(wid):
        logs[wid].flush()
        return (fleet / f".smoke_{wid}.log").read_text()[-3000:]

    sched_tel = RunTelemetry(out_dir=str(fleet), run_name="fleet_scheduler", file_name="scheduler_events.jsonl",
                             config={"lease_seconds": FLEET["lease_seconds"]})
    sched_tel.run_start()
    sched = FleetScheduler(fleet, lease_seconds=FLEET["lease_seconds"], telemetry=sched_tel)
    for mod in (tk, kk, fk):
        mod.reset_launches()
    actions, w0_rc, killed_at = [], None, None
    t_workers = time.perf_counter()
    try:
        spawn("w0", FLEET["w0_fault"])
        deadline = time.time() + FLEET["deadline_s"]
        while not any(l.get("item") == second and l.get("worker") == "w0" for l in q.leases()):
            check(procs["w0"].poll() is None, f"w0 exited {procs['w0'].returncode} early: {tail('w0')}")
            check(time.time() < deadline, "w0 never claimed its second item")
            actions += sched.tick()
            time.sleep(FLEET["tick"])
        w0_second_claim_s = time.perf_counter() - t_workers
        spawn("w1")
        while not q.finished():
            check(time.time() < deadline, f"fleet unfinished: {q.state()['item_counts']}\n{tail('w0')}\n{tail('w1')}")
            if w0_rc is None and procs["w0"].poll() is not None:
                w0_rc, killed_at = procs["w0"].returncode, time.perf_counter() - t_workers
                check(w0_rc == -signal.SIGKILL, f"w0 exited {w0_rc}, not SIGKILLed: {tail('w0')}")
            check(procs["w1"].poll() is None, f"w1 exited {procs['w1'].returncode} early: {tail('w1')}")
            actions += sched.tick()
            time.sleep(FLEET["tick"])
        workers_s = time.perf_counter() - t_workers
        check(procs["w1"].wait(timeout=120) == 0, f"w1 exited {procs['w1'].returncode}: {tail('w1')}")
        if w0_rc is None:
            w0_rc = procs["w0"].wait(timeout=60)
        check(w0_rc == -signal.SIGKILL, f"w0 exited {w0_rc}, not SIGKILLed")
        state = sched.run(poll_every=FLEET["tick"], max_seconds=30)  # the final re-verification pass
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for f in logs.values():
            f.close()
        sched_tel.close()
    smoke_launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
    check(not any(smoke_launches.values()), f"the scheduler's process launched {smoke_launches}")
    check(state["members"] == {"queued": 0, "running": 0, "orphaned": 0, "done": members, "lost": 0},
          f"fleet members {state['members']}")
    kinds = [a["kind"] for a in actions]
    check(kinds == ["lease_expired"], f"scheduler actions {actions}")

    done = {it["item"]: it for it in q.items("done")}
    lineage = {k: [(e.get("worker"), e.get("outcome"), e.get("resumed_from")) for e in it["lineage"]]
               for k, it in done.items()}
    check(lineage[first] == [("w0", "failed", None), ("w0", "done", None)], f"{first} lineage {lineage[first]}")
    check("torn_checkpoint" in done[first]["lineage"][0].get("error", ""), f"{first} failed how? {done[first]}")
    check(lineage[second] == [("w0", "lease_expired", None), ("w1", "done", "ckpt_0")],
          f"{second} lineage {lineage[second]}")
    for item in items:
        ok, reason = verify_export(q.run_dir(item))
        check(ok, f"{item}: export does not verify: {reason}")

    steps, io_retry, statuses = {}, {}, {}
    for item in items:
        events = read_events(q.run_dir(item) / "events.jsonl")
        steps[item] = sum(int(e.get("steps", 0)) for e in events if e["event"] == "chunk_end")
        io_retry[item] = max([e["counters"].get("io.retry", 0) for e in events if e["event"] == "snapshot"] or [0])
        statuses[item] = [e["status"] for e in events if e["event"] == "run_end"]
    chunk_steps = BLS["rows_per_chunk"] // BLS["batch"]
    check(steps == {first: 3 * chunk_steps, second: 2 * chunk_steps}, f"steps per item {steps}")
    check(io_retry[first] >= 1, f"io.retry per item {io_retry}")
    check(statuses[second] == ["ok"] and statuses[first][-1] == "ok", f"run_end statuses {statuses}")

    counts = {wid: json.loads(fleet_counts_path(fleet, wid).read_text()) for wid in ("w0", "w1")}
    worker_kf = sum(c["launches"]["fista_solve"] for c in counts.values())
    for wid, c in counts.items():
        others = {k: v for k, v in c["launches"].items() if k != "fista_solve" and v}
        check(not others and c["plain_solves"] == 0, f"{wid}: other launches {others}, {c['plain_solves']} plain")
    # w0: its first item twice (the torn attempt's chunk, then both chunks),
    # its second item's chunk 0; w1: that item's chunk 1 after the resume
    check({wid: c["launches"]["fista_solve"] for wid, c in counts.items()} == {"w0": 4 * chunk_steps,
                                                                               "w1": chunk_steps},
          f"K_f launches per worker {counts}")
    check(worker_kf == sum(steps.values()), f"workers' K_f launches {worker_kf} != their steps {steps}")

    # an uninterrupted control of each group, in this process under the same
    # watch; its launches read from the wrappers' counts (no profiler trace:
    # a comparison, not the path)
    t_controls = time.perf_counter()
    control_kf, equal_arrays = 0, 0
    for item, grp in zip(items, groups):
        out = root / f"fleet_control_{item}"
        for mod in (tk, kk, fk):
            mod.reset_launches()
        with watching_plain_solves(torch, tf) as plain:
            basic_l1_sweep(output_folder=str(out), l1_values=list(grp), **base)
        launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
        want = {k: 0 for k in launches}
        want["fista_solve"] = 2 * chunk_steps
        check(launches == want and plain["calls"] == 0, f"control {item}: {launches}, {plain['calls']} plain")
        control_kf += launches["fista_solve"]
        got = ckpt_lib.load_learned_dicts(q.run_dir(item) / "epoch_0" / "learned_dicts.pkl", verify=True)
        ref = ckpt_lib.load_learned_dicts(out / "epoch_0" / "learned_dicts.pkl", verify=True)
        check([h for _, h in got] == [h for _, h in ref] and len(got) == group, f"{item}: hyperparams")
        for (g, _), (r, _) in zip(got, ref):
            for f in ("encoder", "encoder_bias", "decoder"):
                check(torch.equal(getattr(g, f), getattr(r, f)), f"{item}: {f} differs from the uninterrupted run")
                equal_arrays += 1
    controls_s = time.perf_counter() - t_controls

    # the fleet through the port's tools
    md = render_fleet_markdown(load_fleet(fleet))
    check(f"**{members} done**" in md and "**0 lost**" in md and "ckpt_0" in md, f"fleet report:\n{md}")
    rc, mon = cli(monitor_main, [str(fleet), "--once"])
    fleet_line = next((ln.strip() for ln in mon.splitlines() if ln.strip().startswith("fleet:")), None)
    check(rc == 0 and fleet_line is not None and f"{members} done" in fleet_line and "0 lost" in fleet_line,
          f"monitor fleet view (rc {rc}):\n{mon}")
    gaps = fleet_reassignment_gaps(fleet)
    ledger = build_ledger(fleet)
    # lease loss → next claim: the torn item's release and w0's re-claim, the
    # killed item's reap and w1's claim (the gap the lease length sets)
    check([(g["item"], g["from_worker"], g["to_worker"]) for g in gaps] == [(first, "w0", "w0"), (second, "w0", "w1")],
          f"gaps {gaps}")
    check(ledger["reassignment_gaps"] == gaps, "the ledger's reassignment gaps")
    gauges = _fleet_gauges(fleet, time.time())
    check(gauges["fleet.pending_items"] == 0.0 and gauges["fleet.leased_items"] == 0.0, f"tower gauges {gauges}")

    # serve a done run dir: the registry verifies the dir, its dicts encode as the export's own
    rows = torch.from_numpy(np.load(store / "0.npy")[:FLEET["serve_rows"]]).cuda().float()
    reg = DictRegistry(device="cuda")
    ids = reg.load_export(q.run_dir(second))
    loaded = ckpt_lib.load_learned_dicts(q.run_dir(second) / "epoch_0" / "learned_dicts.pkl", verify=True)
    check(len(ids) == group, f"registry ids {ids}")
    for did, (ld, _) in zip(ids, loaded):
        check(torch.equal(reg.get(did).ld.encode(rows), ld.encode(rows)), f"{did}: served encode differs")

    # push the runs to a "remote" on this filesystem and pull the newest back
    remote = f"localhost:{root / 'remote'}"
    (root / "remote" / "outputs").mkdir(parents=True)  # the remote's tree exists, as on a real host
    t_sync = time.perf_counter()
    push_outputs(fleet / "runs", remote=remote, runner=local_host_runner)
    pull_latest_outputs(remote=remote, local=str(root / "pulled"), runner=local_host_runner)
    sync_s = time.perf_counter() - t_sync
    for item in items:
        pulled = root / "pulled" / "runs" / item
        ok, reason = verify_export(pulled)
        check(ok, f"pulled {item}: {reason}")
        check(sha256_file(pulled / "export_manifest.json") == sha256_file(q.run_dir(item) / "export_manifest.json"),
              f"pulled {item}: manifest differs")
        a = ckpt_lib.load_learned_dicts(pulled / "epoch_0" / "learned_dicts.pkl", verify=True)
        b = ckpt_lib.load_learned_dicts(q.run_dir(item) / "epoch_0" / "learned_dicts.pkl", verify=True)
        check(all(torch.equal(x.decoder, y.decoder) for (x, _), (y, _) in zip(a, b)), f"pulled {item}: dicts differ")

    emit("fleet", config="BASELINE config 1", bytes_per_member=per_member, hbm_budget_bytes=budget,
         groups=[len(g) for g in groups], items=items, members_done=state["members"]["done"],
         members_lost=state["members"]["lost"], w0_fault=FLEET["w0_fault"], w0_exit=w0_rc,
         lease_seconds=FLEET["lease_seconds"], lineage=lineage, steps=steps, io_retry=io_retry,
         kf_launches_workers={wid: c["launches"]["fista_solve"] for wid, c in counts.items()},
         kf_launches_controls=control_kf, plain_solves=0, export_arrays_bit_equal=equal_arrays,
         reassignment_gap_s={g["item"]: g["seconds"] for g in gaps}, tower_gauges=gauges, monitor_fleet_line=fleet_line,
         served_dicts=len(ids), synced_runs=len(items), w0_second_claim_s=w0_second_claim_s,
         w0_killed_at_s=killed_at, workers_s=workers_s, controls_s=controls_s, sync_s=sync_s,
         phase_s=time.perf_counter() - t_phase)
    return worker_kf


def sweep_cfg(root: Path, out: str):
    from sparse_coding__tpu_torch.utils.config import SyntheticEnsembleArgs

    return SyntheticEnsembleArgs(
        use_synthetic_dataset=True, activation_width=D, n_ground_truth_components=1024, feature_num_nonzero=8,
        feature_prob_decay=0.996, n_chunks=SWEEP["chunks"], chunk_size_gb=SWEEP["chunk_size_gb"], n_epochs=1,
        batch_size=B, dataset_folder=str(root / "act"), output_folder=str(root / out), seed=0,
    )


def sweep_init(cfg):
    """The sweep's two ensembles (module level: the resume subprocesses
    build the same ones)."""
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.utils.optim import linear_schedule

    kw = dict(compute_dtype="bfloat16", activation_size=D, n_dict_components=N)
    a = pkg.build_ensemble(pkg.FunctionalTiedSAE, 0, [{"l1_alpha": x} for x in L1_GRID],
                           optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, **kw)
    schedule = linear_schedule(0.0, LR, SWEEP["warmup_steps"])
    b = pkg.build_ensemble(pkg.FunctionalTiedSAE, 1, [{"l1_alpha": x} for x in L1_GRID[:SWEEP["members_b"]]],
                           optimizer_kwargs={"learning_rate": schedule, "mu_dtype": "bfloat16"}, **kw)
    args = {"batch_size": cfg.batch_size, "dict_size": N}
    return ([(a, args, "adam"), (b, args, "warmup")], ["dict_size"], ["l1_alpha"],
            {"l1_alpha": L1_GRID, "dict_size": [N]})


def sweep_worker(argv) -> int:
    """``chip_smoke.py --sweep-worker <root> <out> [--resume]``: the sweep as
    a process of its own (``SC_FAULT`` from the environment)."""
    import warnings

    from sparse_coding__tpu_torch.train.sweep import sweep

    warnings.simplefilter("ignore", UserWarning)  # the schedule's fused-Adam refusal, shown in-process
    sweep(sweep_init, sweep_cfg(Path(argv[0]), argv[1]), resume="--resume" in argv[2:])
    return 0


def span_seconds(events, category: str) -> float:
    return sum(e["seconds"] for e in events if e["event"] == "span" and e["category"] == category)


def phase_sweep_train(torch, root: Path):
    """The sweep driver end to end at config 2's widths: the store built on
    the card, both ensembles trained over it, the export and checkpoint
    committed. A runs K1 + K2 on every step, B K1 + K3, nothing else runs
    (`run_counted`; ``wall_s`` is traced). Returns the export's path."""
    import warnings

    import numpy as np

    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.train.sweep import sweep

    cfg = sweep_cfg(root, "out_a")
    routes = {}

    def init(c):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = sweep_init(c)
        for ens, _args, name in out[0]:
            routes[name] = {"members": ens.n_models, "fused": ens.fused, "fused_adam": ens.fused_adam is not None}
        routes["refusals"] = [str(w.message) for w in caught]
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, reserved_before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        lds = sweep(init, cfg)
        torch.cuda.synchronize()
        return lds, time.perf_counter() - t0

    (lds, wall), launches, short = run_counted(torch, run)
    # allocated: what the steps and the sweep driver hold at once; reserved adds
    # what the allocator keeps, the two step graphs' private pools among it
    peak = torch.cuda.max_memory_allocated() - before
    peak_reserved = torch.cuda.max_memory_reserved() - reserved_before
    rows = SWEEP["chunks"] * int(SWEEP["chunk_size_gb"] * 1024**3 // (D * 2))
    steps = rows // B  # per ensemble
    want = {k: 0 for k in launches}
    want.update(tied_sae_fwd=2 * steps, tied_sae_bwd_adam=steps, tied_sae_bwd_grads=steps)
    check(routes["adam"] == {"members": M, "fused": True, "fused_adam": True}, f"ensemble A's route {routes}")
    check(routes["warmup"] == {"members": SWEEP["members_b"], "fused": True, "fused_adam": False},
          f"ensemble B's route {routes}")
    check(launches == want, f"sweep launches {launches} after {steps} steps an ensemble, want {want}")
    events = read_events(Path(cfg.output_folder) / "events.jsonl")
    check([e["status"] for e in events if e["event"] == "run_end"] == ["ok"], "sweep run_end")
    export = Path(cfg.output_folder) / f"_{SWEEP['chunks'] - 1}" / "learned_dicts.pkl"
    check(ckpt_lib.verify_checkpoint(Path(cfg.output_folder) / f"ckpt_{SWEEP['chunks'] - 1}") == (True, "ok"),
          "the final checkpoint does not verify")
    loaded = ckpt_lib.load_learned_dicts(export, verify=True)
    check(len(loaded) == len(lds) == M + SWEEP["members_b"], f"{len(loaded)} exported dicts")
    sample = torch.from_numpy(np.load(Path(cfg.dataset_folder) / "0.npy")[:4096]).cuda().float()
    metrics = evaluate_dicts([ld for ld, _ in loaded], sample)
    fvu = [m["fvu"] for m in metrics]
    # finite everywhere; each ensemble's lowest-l1 member has learned (the
    # high-l1 members of so short a run may still sit near FVU 1)
    check(all(math.isfinite(v) for v in fvu) and max(fvu[0], fvu[M]) < 0.75, f"sweep FVU {fvu}")
    PHASE_WALL["sweep_train"] = wall
    emit("sweep_train", config="BASELINE config 2 widths", members={"A": M, "B": SWEEP["members_b"]}, routes=routes,
         chunks=SWEEP["chunks"], rows=rows, batch=B, steps_per_ensemble=steps, launches=launches,
         trace_short=short, wall_s=wall,
         activations_per_s=steps * B * (M + SWEEP["members_b"]) / wall,
         span_seconds={c: span_seconds(events, c) for c in ("step", "checkpoint", "data_wait")},
         sweep_peak_bytes=peak, sweep_peak_reserved_bytes=peak_reserved, fvu=fvu, l0=[m["l0"] for m in metrics])
    return export


def phase_sweep_resume(torch, root: Path, control_export: Path):
    """The same sweep preempted by a real SIGTERM at position 1 in a process
    of its own (exit 75, a committed ``ckpt_1``), then resumed in another:
    its final export must equal the uninterrupted run's bit for bit."""
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib

    def worker(*extra, fault=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
        if fault:
            env["SC_FAULT"] = fault
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--sweep-worker", str(root), "out_b",
                               *extra], env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - t

    out = root / "out_b"
    killed, killed_s = worker(fault="sigterm:chunk=1")
    check(killed.returncode == 75, f"preempted sweep exited {killed.returncode}: {killed.stderr[-3000:]}")
    ok = ckpt_lib.verify_checkpoint(out / "ckpt_1")
    check(ok == (True, "ok") and ckpt_lib.latest_checkpoint(out).name == "ckpt_1", f"ckpt_1: {ok}")
    resumed, resumed_s = worker("--resume")
    check(resumed.returncode == 0, f"resumed sweep exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    got = ckpt_lib.load_learned_dicts(out / control_export.parent.name / "learned_dicts.pkl", verify=True,
                                      device="cpu")
    ref = ckpt_lib.load_learned_dicts(control_export, verify=True, device="cpu")
    check(len(got) == len(ref), "resumed export length")
    for (g, hg), (r, hr) in zip(got, ref):
        check(hg == hr, f"hyperparams {hg} != {hr}")
        for f in ("encoder", "encoder_bias"):
            check(torch.equal(getattr(g, f), getattr(r, f)), f"resumed {f} differs from the uninterrupted run's")
    events = read_events(out / "events.jsonl")
    kinds = {e["event"] for e in events}
    preempt = [e for e in events if e["event"] == "preempt"]
    statuses = [e["status"] for e in events if e["event"] == "run_end"]
    check({"preempt", "resume", "checkpoint"} <= kinds, f"events {sorted(kinds)}")
    check(len(preempt) == 1 and preempt[0]["signum"] == 15, f"preempt events {preempt}")
    check(statuses == ["preempted", "ok"], f"run_end statuses {statuses}")
    emit("sweep_resume", fault="sigterm:chunk=1", preempted_exit=killed.returncode, preempted_s=killed_s,
         resumed_s=resumed_s, checkpoint="ckpt_1", run_end=statuses, bit_equal_arrays=2 * len(got),
         resume_cursor=next(e for e in events if e["event"] == "resume")["cursor"])


def graph_pool_bytes(torch):
    """Bytes reserved in each private memory pool (a CUDA graph's), by pool,
    from the allocator's segment snapshot; None where the snapshot does not
    name its segments' pools."""
    pools, named = {}, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if tuple(pid) != (0, 0):
            pools[str(tuple(pid))] = pools.get(str(tuple(pid)), 0) + int(seg["total_size"])
    return pools if named else None


def phase_experiments_synthetic(torch, root: Path, launches_at):
    """The experiment catalog as a user runs it: `run_sweep_synthetic` with
    builders in turn (`EXPERIMENTS`) over one synthetic store (the first run
    builds it and saves its ground truth), three in bf16 compute, the
    default builder in exact f32, then the four ablation builders (LISTA,
    thresholding, the masked dict-ratio stack also in bf16, positive).
    Launches: every count set to 0 just before a run and read just after,
    and around each of its train loop calls set to 0 on entry and read on
    exit, so each ensemble's launches are its loops' and no kernel may
    launch outside the loops. K1 = K2 = steps on each bf16 tied ensemble,
    none of the hand-written kernels on the untied, the ablations' and the
    f32 ones (their route is autograd), K_s = K_d = the sparse K2 = steps on
    each TopK ensemble. The export reloads in the port equal to what the sweep
    returned; `evaluate_dicts` equals each dict evaluated alone (rtol 1e-6);
    `hungarian_matched_mcs` of each ensemble's first member against the
    saved ground truth; `calc_moments_streaming` of each run's first dict
    against the exact moments of one batch (rtol 1e-5). Prints per builder:
    activations/s end to end and in the ``step`` spans, the span seconds,
    the peak allocated memory and the bytes the ensembles' graph pools keep
    reserved (all ensembles of a run live at once). ``launches_at`` collects
    the launches of the ensembles at the kernel checks' shapes."""
    import numpy as np

    from sparse_coding__tpu_torch.metrics import standard as sm
    from sparse_coding__tpu_torch.models.learned_dict import dict_leaves
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.train import experiments as ex
    from sparse_coding__tpu_torch.train import sweep as sweep_mod

    E = EXPERIMENTS
    width, batch = E["width"], E["batch"]
    store = root / "act"
    steps = E["chunks"] * E["rows_per_chunk"] // batch  # per ensemble
    # the hand-written kernels each signature's bf16 step launches (the
    # others take the autograd step: none)
    fused = {"FunctionalTiedSAE": ("tied_sae_fwd", "tied_sae_bwd_adam"),
             "TopKEncoderApprox": ("topk_scores", "topk_decode", "tied_sae_bwd_adam_sparse")}
    real_loop = sweep_mod.ensemble_train_loop

    def counts():
        return {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}

    def reset():
        for mod in (tk, kk, fk):
            mod.reset_launches()

    def add(into, got):
        for k, v in got.items():
            into[k] = into.get(k, 0) + v

    truth = None
    for name, dtype in E["builders"]:
        out = root / f"{name}_{dtype}"
        held, per_ens, outside = [], {}, {}

        def builder(cfg, _b=getattr(ex, name), **kw):
            res = _b(cfg, **kw)
            held.extend(res[0])
            return res

        def counted_loop(ens, *a, **kw):
            add(outside, counts())  # what launched since the last read: outside the loops
            reset()
            r = real_loop(ens, *a, **kw)
            add(per_ens.setdefault(id(ens), {}), counts())
            reset()
            return r

        overrides = dict(n_chunks=E["chunks"], chunk_size_gb=E["rows_per_chunk"] * width * 2 / 1024**3,
                         n_epochs=E["epochs"], dataset_folder=str(store), output_folder=str(out))
        if name == "topk_experiment":
            overrides["topk_recall"] = E["topk_recall"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sweep_mod.ensemble_train_loop = counted_loop
        reset()
        try:
            t0 = time.perf_counter()
            lds = ex.run_sweep_synthetic(builder, dtype=dtype, **overrides)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sweep_mod.ensemble_train_loop = real_loop
        add(outside, counts())
        check(not any(outside.values()), f"{name}: launches outside the train loops {outside}")
        peak = torch.cuda.max_memory_allocated() - before
        torch.cuda.empty_cache()
        pools = graph_pool_bytes(torch)
        reserved_unallocated = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        if truth is None:
            truth = torch.from_numpy(np.load(out / "ground_truth_dict.npy")).cuda().float()
            check(truth.shape == (2048, width), f"ground truth {tuple(truth.shape)}")

        ensembles, total = [], 0
        for ens, args, ens_name in held:
            sig = ens.sig.__name__
            kernels = fused.get(sig, ()) if dtype == "bfloat16" else ()
            want = dict.fromkeys(counts(), 0)
            want.update(dict.fromkeys(kernels, steps))
            got = per_ens.get(id(ens))
            route = ens._route(batch, False, False)
            check(route == ("fused_adam" if kernels else "autograd"), f"{ens_name}: route {route}")
            check(got == want, f"{name}/{ens_name} ({sig}): launches {got}, want {want}")
            total += steps * batch * ens.n_models
            ensembles.append(dict(name=ens_name, sig=sig, members=ens.n_models, dict_size=args["dict_size"],
                                  route=route, steps=steps, captures=ens.captures,
                                  launches={k: v for k, v in got.items() if v}))
            if kernels and args["dict_size"] == EXP_TIED[2]:
                launches_at[sig] = got
        events = read_events(out / "events.jsonl")
        check([e["status"] for e in events if e["event"] == "run_end"] == ["ok"], f"{name}: run_end")
        spans = {c: span_seconds(events, c) for c in ("step", "checkpoint", "data_wait")}

        # the export as written, reloaded
        loaded = ckpt_lib.load_learned_dicts(out / f"_{E['chunks'] - 1}" / "learned_dicts.pkl", verify=True)
        check(len(loaded) == len(lds) == sum(e["members"] for e in ensembles), f"{name}: {len(loaded)} exported")
        for (a, ha), (b, hb) in zip(lds, loaded):
            check(type(a) is type(b) and ha == hb, f"{name}: export {type(b).__name__} {hb}, wrote {ha}")
            la, lb = dict_leaves(a), dict_leaves(b)
            check(len(la) == len(lb) and all(fa == fb and pa == pb and torch.equal(ta, tb)
                                             for (fa, pa, ta), (fb, pb, tb) in zip(la, lb)),
                  f"{name}: an exported array of {type(a).__name__} differs")
        dicts = [ld for ld, _ in loaded]
        sample = torch.from_numpy(np.load(store / "0.npy")[:E["eval_rows"]]).cuda().float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluated = sm.evaluate_dicts(dicts, sample)
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = [{"fvu": float(sm.fraction_variance_unexplained(ld, sample)), "l0": float(sm.sparsity_l0(ld, sample))}
                 for ld in dicts]
        alone_s = time.perf_counter() - t0
        worst = 0.0
        for ev, al in zip(evaluated, alone):
            for k in ("fvu", "l0"):
                worst = max(worst, abs(ev[k] - al[k]) / max(abs(al[k]), 1e-30))
                check(math.isclose(ev[k], al[k], rel_tol=1e-6), f"{name}: evaluate_dicts {k} {ev[k]} vs {al[k]}")
        fvu = [r["fvu"] for r in evaluated]
        check(all(math.isfinite(v) for v in fvu), f"{name}: FVU {fvu}")
        firsts, i = [], 0
        for e in ensembles:
            firsts.append(i)
            i += e["members"]
        hung = []
        t0 = time.perf_counter()
        for j in firsts:
            vals, cols = sm.hungarian_matched_mcs(dicts[j], truth)
            check(len(vals) == len(cols) == min(2048, dicts[j].n_feats) and bool(torch.isfinite(vals).all())
                  and float(vals.abs().max()) <= 1 + 1e-5, f"{name}: matched MCS of dict {j}")
            hung.append(float(vals.mean()))
        hung_s = time.perf_counter() - t0
        one = sample[:batch]
        times_a, mean, var, _skew, _kurt, m4 = sm.calc_moments_streaming(dicts[0], one, batch_size=batch)
        # the second moment as var + mean² (the f32 difference m2 - mean² keeps
        # m2's rounding, which is relative to m2, not to var)
        c = dicts[0].encode(one).double()
        exact = {"mean": c.mean(0), "m2": (c ** 2).mean(0), "m4": (c ** 4).mean(0)}
        for k, v in (("mean", mean.double()), ("m2", var.double() + mean.double() ** 2), ("m4", m4.double())):
            ref = exact[k]
            ok = torch.allclose(v, ref, rtol=1e-5, atol=1e-7 * float(ref.abs().max()))
            check(ok, f"{name}: streaming {k} off the exact moment by {float((v - ref).abs().max())}")
        check(torch.equal(times_a.double(), (exact["mean"] != 0).double()), f"{name}: streaming times_active")
        emit("experiments_synthetic", builder=name, width=width, batch=batch, compute_dtype=dtype,
             cut=f"depth: {E['chunks']} chunks of {E['rows_per_chunk']} rows, {E['epochs']} epoch "
                 "(run_sweep_synthetic's default: 10 chunks of 2 GB); widths as published",
             ground_truth_components=2048, active=100, decay=0.996, ensembles=ensembles, steps_per_ensemble=steps,
             wall_s=wall, activations=total, activations_per_s=total / wall,
             step_span_activations_per_s=total / spans["step"], span_seconds=spans, peak_allocated_bytes=peak,
             graph_pool_bytes=None if pools is None else sum(pools.values()), graph_pools=pools,
             reserved_unallocated_bytes=reserved_unallocated, capture_s=sum(e.capture_seconds for e, _, _ in held),
             launches_outside_loops=outside, exported=len(loaded), export_reload_equal=True,
             eval_dicts_s=eval_s, eval_one_read_a_dict_and_metric_s=alone_s, eval_max_rel_diff=worst,
             fvu_min=min(fvu), fvu_max=max(fvu), hungarian_mean_mcs=hung, hungarian_s=hung_s, moments_checked=True)
        # nothing may keep this run's ensembles (and their graph pools) alive
        # into the next run's measurement
        del held, lds, loaded, dicts, per_ens, ens, builder
        shutil.rmtree(out)  # its checkpoint and export: ~1 GB a builder
        torch.cuda.empty_cache()


def signature_models(pkg, width: int, n_dict: int, members: int):
    """``(name, signature, init kwargs, member hparams)`` of the signatures
    no catalog builder trains, an l1 (or sparsity) grid over ``members``."""
    grid = [10 ** (-4 + 2 * i / max(members - 1, 1)) for i in range(members)]
    tied = dict(activation_size=width, n_dict_components=n_dict)
    return [
        ("FunctionalTiedCenteredSAE", pkg.FunctionalTiedCenteredSAE, tied, [{"l1_alpha": a} for a in grid]),
        ("FunctionalMaskedSAE", pkg.FunctionalMaskedSAE, dict(activation_size=width, n_components_stack=n_dict),
         [{"l1_alpha": 1e-3, "n_dict_components": n_dict * (i % 4 + 1) // 4} for i in range(members)]),
        ("FunctionalReverseSAE", pkg.FunctionalReverseSAE, tied,
         [{"l1_alpha": a, "bias_decay": 0.05 * (i % 2)} for i, a in enumerate(grid)]),
        ("FunctionalResidualDenoisingSAE", pkg.FunctionalResidualDenoisingSAE,
         dict(d_activation=width, n_features=n_dict, n_hidden_layers=3), [{"l1_alpha": a} for a in grid]),
        ("SemiLinearSAE", pkg.SemiLinearSAE, tied, [{"l1_alpha": a} for a in grid]),
        ("RICA", pkg.RICA, tied, [{"sparsity_coef": 0.1, "sparsity_loss": "l1" if i % 2 else "smooth_l1"}
                                  for i in range(members)]),
        ("DirectCoefOptimizer", pkg.DirectCoefOptimizer, dict(d_activation=width, n_features=n_dict),
         [{"l1_alpha": a} for a in grid]),
    ]


def phase_signatures(torch, pkg):
    """The signatures no catalog builder trains (`SIGNATURES`): for each, at
    D 512, N 2048, 8 members, batch 1024 (exact f32, autograd): from cloned
    states, ``steps`` replays of the captured step (`step_scan`) against
    ``steps`` eager `step_batch` calls, losses and state bit for bit, one
    capture, no hand-written kernel launched; its graph steps a second
    (CUDA events over the replays), the peak allocated memory and the graph
    pool's bytes. Then the same steps at the small shape on the card and on
    the CPU, each from the CPU's state (`Ensemble.from_state`): losses rtol
    1e-5 and params within 1e-2 lr (the f32 autograd parity tests' bounds),
    except elements whose CPU gradient is f32 cancellation noise (at most
    1e-6 of the leaf's largest), which Adam turns into up to its bound
    (1 - b1) / sqrt(1 - b2) lr in either place: those within that bound.
    Then `models.pca.calc_pca` of one chunk on the card against a float64
    numpy covariance and mean, and its `get_centering_transform` whitening
    the chunk to unit covariance."""
    import numpy as np
    from _torch_moments import state_differences

    from sparse_coding__tpu_torch.models import pca
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    S = SIGNATURES
    t_phase = time.perf_counter()
    results = {}
    for name, sig, common, hparams in signature_models(pkg, S["width"], S["n_dict"], S["members"]):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pools_before = graph_pool_bytes(torch) or {}
        a = pkg.build_ensemble(sig, 11, hparams, optimizer_kwargs={"learning_rate": LR}, device="cuda", **common)
        b = pkg.Ensemble.from_state(a.state_dict(), sig=sig, device="cuda")
        check(a._route(S["batch"], False, False) == "autograd", f"signatures {name}: route")
        g = torch.Generator(device="cuda").manual_seed(S["pca_seed"])
        xs = torch.randn((S["steps"] + 1, S["batch"], S["width"]), generator=g, device="cuda")
        for mod in (tk, kk, fk):
            mod.reset_launches()
        a.step_scan(xs[:1])
        b.step_batch(xs[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        la = a.step_scan(xs[1:])
        end.record()
        lb = [b.step_batch(x)[0] for x in xs[1:]]
        torch.cuda.synchronize()
        launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
        check(not any(launches.values()), f"signatures {name}: hand-written kernels launched {launches}")
        check(a.captures == 1, f"signatures {name}: {a.captures} captures")
        for k in lb[0]:
            check(torch.equal(la[k], torch.stack([l[k] for l in lb])), f"signatures {name}: graph {k} differs")
        diff = state_differences(a.state, b.state)
        check(diff == [], f"signatures {name}: graph state differs from eager at {diff}")
        check(all(bool(torch.isfinite(v).all()) for v in la.values()), f"signatures {name}: losses {la}")
        replay_ms = start.elapsed_time(end) / S["steps"]
        peak = torch.cuda.max_memory_allocated() - before
        pools = graph_pool_bytes(torch)
        pool_bytes = None if pools is None else sum(v for k, v in pools.items() if k not in pools_before)
        del a, b, xs, la, lb
        torch.cuda.empty_cache()
        small = signature_small_parity(torch, pkg, sig, name, hparams, common)
        results[name] = dict(members=S["members"], steps=S["steps"], graph_step_ms=replay_ms,
                             steps_per_s=1000.0 / replay_ms, peak_allocated_bytes=peak, graph_pool_bytes=pool_bytes,
                             bit_equal=True, launches=0, small_parity=small, seconds=time.perf_counter() - t0)

    # streaming PCA of one chunk, against float64
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(S["pca_seed"])
    D_ = S["width"]
    scales = torch.linspace(1.0, 16.0, D_, device="cuda")
    mix = torch.linalg.qr(torch.randn((D_, D_), generator=g, device="cuda"))[0]
    x = (torch.randn((S["pca_rows"], D_), generator=g, device="cuda") * scales) @ mix + 3.0
    fit = pca.calc_pca(x, device="cuda")
    ref = x.cpu().double().numpy()
    mean64, cov64 = ref.mean(0), np.cov(ref.T, bias=True)
    mean_err = float(np.abs(fit.get_mean().cpu().double().numpy() - mean64).max())
    cov_err = float(np.abs(fit.cov.cpu().double().numpy() - cov64).max() / np.abs(cov64).max())
    check(mean_err <= 1e-4 and cov_err <= 1e-4, f"signatures pca: mean err {mean_err}, cov rel err {cov_err}")
    t, r, s_ = fit.get_centering_transform()
    w = (((x - t) @ r) * s_).double()
    white_err = float((w.T @ w / w.shape[0] - torch.eye(D_, device="cuda", dtype=torch.float64)).abs().max())
    check(white_err <= 1e-3, f"signatures pca: whitened covariance off the identity by {white_err}")
    pca_s = time.perf_counter() - t0
    del x, w, fit
    torch.cuda.empty_cache()
    emit("signatures", width=S["width"], n_dict=S["n_dict"], batch=S["batch"], signatures=results,
         pca=dict(rows=S["pca_rows"], mean_max_abs_err=mean_err, cov_max_rel_err=cov_err,
                  whitened_cov_max_err=white_err, seconds=pca_s),
         seconds=time.perf_counter() - t_phase)


def signature_small_parity(torch, pkg, sig, name, hparams, common):
    """``steps`` steps at `SIGNATURES`' small shape, each from the CPU
    ensemble's state on both the CPU and the card (see `phase_signatures`):
    the worst loss rel error, param error in lr, and the noise elements'
    count."""
    from sparse_coding__tpu_torch.utils.tree import tree_leaves

    S = SIGNATURES
    D_, N_, M_, B_ = S["small"]
    grid = hparams[:M_]
    kw = {k: (N_ if v == S["n_dict"] else D_ if v == S["width"] else v) for k, v in common.items()}
    if name == "FunctionalMaskedSAE":
        grid = [dict(hp, n_dict_components=N_ * (i % 4 + 1) // 4) for i, hp in enumerate(grid)]
    cpu = pkg.build_ensemble(sig, 5, grid, optimizer_kwargs={"learning_rate": LR}, device="cpu", **kw)
    x = torch.randn((S["steps"], B_, D_), generator=torch.Generator().manual_seed(7))
    bound = (1 - B1) / (1 - B2) ** 0.5 * LR
    worst_loss, worst_param, noisy_n = 0.0, 0.0, 0
    for k in range(S["steps"]):
        card = pkg.Ensemble.from_state(cpu.state_dict(), sig=sig, device="cuda")
        before = [t.clone() for t in tree_leaves(cpu.state.params)]
        grads = tree_leaves(cpu._grads(cpu.state.params, cpu.state.buffers, x[k])[0])
        lc, _ = cpu.step_batch(x[k])
        lg, _ = card.step_batch(x[k].cuda())
        for key in lc:
            rel = float(((lg[key].cpu() - lc[key]).abs() / lc[key].abs().clamp_min(1e-30)).max())
            worst_loss = max(worst_loss, rel)
        for gr, p0, pc, pg in zip(grads, before, tree_leaves(cpu.state.params), tree_leaves(card.state.params)):
            noisy = gr.abs() <= 1e-6 * gr.abs().max()
            noisy_n += int(noisy.sum())
            d = (pg.cpu() - pc).abs()
            check(float(torch.where(noisy, (pg.cpu() - p0).abs(), torch.zeros_like(d)).max()) <= bound * 1.0001,
                  f"signatures {name}: a noise element moved past Adam's bound")
            worst_param = max(worst_param, float(torch.where(noisy, torch.zeros_like(d), d).max()) / LR)
        del card
    check(worst_loss <= 1e-5, f"signatures {name}: card vs CPU loss rel {worst_loss}")
    check(worst_param <= 1e-2, f"signatures {name}: card vs CPU params {worst_param} lr")
    return dict(shape=dict(D=D_, N=N_, M=M_, B=B_), steps=S["steps"], max_loss_rel=worst_loss,
                max_param_diff_lr=worst_param, noise_elements=noisy_n)


def harvest_chunk_rows(cfg) -> int:
    """Rows a harvested chunk holds (`data.activations._harvest_plan`'s
    geometry: whole batches of ``batch x seq`` rows within the chunk size)."""
    per_batch = HARVEST["batch"] * HARVEST["seq"]
    return max(1, int(HARVEST["chunk_size_gb"] * 1024**3 // (cfg.d_model * 2)) // per_batch) * per_batch


def harvest_kwargs():
    return dict(layers=[HARVEST["layer"]], layer_locs=list(HARVEST["locs"]), batch_size=HARVEST["batch"],
                chunk_size_gb=HARVEST["chunk_size_gb"], n_chunks=HARVEST["chunks"])


def harvest_worker(argv) -> int:
    """``chip_smoke.py --harvest-worker <root> <out> [--resume]``: the f32
    harvest of the `harvest` phase as a process of its own, on the subject
    and tokens the phase saved in ``root`` (``SC_FAULT`` from the
    environment)."""
    import numpy as np
    import torch

    from sparse_coding__tpu_torch.data.activations import make_activation_dataset
    from sparse_coding__tpu_torch.lm import config_for

    root = Path(argv[0])
    params = torch.load(root / "subject.pt", map_location="cuda", weights_only=True)
    make_activation_dataset(params, config_for(SUBJECT["model"]), np.load(root / "tokens.npy"), root / argv[1],
                            resume="--resume" in argv[2:], device="cuda", **harvest_kwargs())
    return 0


def phase_subject_pretrain(torch, root: Path):
    """`lm.pretrain.pretrain_lm` on a seeded random init of Pythia-70M's
    widths over the trigram corpus, bf16 compute at JAX's defaults; the loss
    must fall by at least a nat (as the JAX suite asks at its size). Saves
    the params for the harvest workers; returns (cfg, params, language)."""
    from sparse_coding__tpu_torch.data.synthetic_text import TrigramLanguage
    from sparse_coding__tpu_torch.lm import config_for, init_params, model as lm_model
    from sparse_coding__tpu_torch.lm.pretrain import pretrain_lm

    cfg = config_for(SUBJECT["model"])
    t0 = time.perf_counter()
    lang = TrigramLanguage(cfg.vocab_size, seed=SUBJECT["lang_seed"])
    corpus = lang.sample(*SUBJECT["corpus"], seed=SUBJECT["corpus_seed"])
    corpus_s = time.perf_counter() - t0
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in lm_model.tree_leaves(params).values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, stats = pretrain_lm(params, cfg, corpus, n_steps=SUBJECT["steps"], batch_size=SUBJECT["batch"],
                                learning_rate=SUBJECT["lr"], compute_dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    fall = stats["loss_first"] - stats["loss_last"]
    check(math.isfinite(stats["loss_last"]) and fall >= 1.0, f"pretrain loss {stats}: fell {fall} nats, want >= 1")
    torch.save(params, root / "subject.pt")
    tokens = SUBJECT["steps"] * SUBJECT["batch"] * SUBJECT["corpus"][1]
    emit("subject_pretrain", model=SUBJECT["model"], cfg=dataclasses.asdict(cfg), params=n_params,
         cut=f"depth: {SUBJECT['steps']} steps from a seeded random init (no downloadable weights); widths as published",
         corpus=list(SUBJECT["corpus"]), corpus_s=corpus_s, steps=SUBJECT["steps"], batch=SUBJECT["batch"],
         compute_dtype="bfloat16", seconds=seconds, tokens_per_s=tokens / seconds, loss_first=stats["loss_first"],
         loss_last=stats["loss_last"], loss_fall=fall, entropy_bound=lang.per_token_entropy_bound,
         peak_allocated_bytes=peak)
    return cfg, params, lang


def phase_harvest(torch, root: Path, cfg, params, lang):
    """`make_activation_dataset` on a held-out sample of the language, layer
    2's residual and MLP output in one pass, f32 compute, with a live
    `RunTelemetry` receiving the harvest's spans; then `harvest_to_device`
    on the same params and tokens, every chunk of both locations the disk
    store's bits; then one chunk in bf16 compute within JAX's bound (max
    |Δ| / max |x| < 0.05) of the f32 one. Returns the store's folders."""
    import numpy as np

    from sparse_coding__tpu_torch.data.activations import harvest_to_device, make_activation_dataset
    from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

    tokens = lang.sample(HARVEST["rows"], HARVEST["seq"], seed=HARVEST["seed"])
    np.save(root / "tokens.npy", tokens)
    kw = harvest_kwargs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tel = RunTelemetry()
    try:
        t0 = time.perf_counter()
        folders = make_activation_dataset(params, cfg, tokens, root / "acts", device="cuda", **kw)
        wall = time.perf_counter() - t0
    finally:
        tel.close()
    peak = torch.cuda.max_memory_allocated() - before
    spans = {"harvest_forward": tel.counters.get("span.step.seconds", 0.0),
             "chunk_commit": tel.counters.get("span.checkpoint.seconds", 0.0)}
    chunk_rows = harvest_chunk_rows(cfg)
    rows = HARVEST["chunks"] * chunk_rows
    for key, folder in folders.items():
        for i in range(HARVEST["chunks"]):
            arr = np.load(folder / f"{i}.npy", mmap_mode="r")
            check(arr.shape == (chunk_rows, cfg.d_model) and arr.dtype == np.float16, f"{key} chunk {i}: {arr.shape}")
            check(bool(np.isfinite(arr).all()), f"{key} chunk {i} is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = list(harvest_to_device(params, cfg, tokens, device="cuda", **kw))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    equal = 0
    for i, chunk in enumerate(chunks):
        for key, folder in folders.items():
            disk = torch.from_numpy(np.load(folder / f"{i}.npy"))
            check(torch.equal(chunk[key].cpu().view(torch.int16), disk.view(torch.int16)),
                  f"harvest_to_device chunk {i} of {key} differs from the disk store")
            equal += 1
    del chunks, chunk
    (bf,) = harvest_to_device(params, cfg, tokens, device="cuda", compute_dtype="bfloat16",
                              **{**kw, "n_chunks": 1})
    bf16_rel = {}
    for key, folder in folders.items():
        a = torch.from_numpy(np.load(folder / "0.npy")).cuda().float()
        bf16_rel[key[1]] = float((a - bf[key].float()).abs().max() / a.abs().max())
        check(bf16_rel[key[1]] < 0.05, f"bf16 harvest of {key}: {bf16_rel[key[1]]} of the f32 one's max")
    del bf
    emit("harvest", layer=HARVEST["layer"], locs=list(HARVEST["locs"]), tokens=list(tokens.shape),
         batch=HARVEST["batch"], chunk_rows=chunk_rows, chunks=HARVEST["chunks"], compute_dtype="float32",
         wall_s=wall, tokens_per_s=rows / wall, span_seconds=spans,
         host_share=spans["chunk_commit"] / wall, peak_allocated_bytes=peak,
         to_device_s=device_s, to_device_tokens_per_s=rows / device_s, to_device_chunks_bit_equal=equal,
         bf16_max_rel_diff=bf16_rel)
    return folders


def phase_harvest_resume(torch, root: Path, control: dict):
    """The `harvest` phase's harvest in a process of its own, SIGKILLed in
    chunk 1's pair gap (``SC_FAULT=kill:chunk_pair:chunk=1``), then resumed
    with ``resume=True`` in another: every chunk's .npy bytes and every
    manifest's file digests equal the uninterrupted harvest's."""
    from sparse_coding__tpu_torch.data import integrity
    from sparse_coding__tpu_torch.data.activations import harvest_folder_name, read_harvest_cursor

    def worker(*extra, fault=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
        if fault:
            env["SC_FAULT"] = fault
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--harvest-worker", str(root), "resumed",
                               *extra], env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - t

    killed, killed_s = worker(fault="kill:chunk_pair:chunk=1")
    check(killed.returncode == -9, f"killed harvest exited {killed.returncode}: {killed.stderr[-3000:]}")
    folders = {key: harvest_folder_name(root / "resumed", *key) for key in control}
    first = next(iter(folders.values()))
    check(integrity.read_chunk_manifest(first, 1) is None and read_harvest_cursor(first)["chunk"] == 1,
          "the killed harvest's chunk 1 is committed, or its cursor is not at 1")
    resumed, resumed_s = worker("--resume")
    check(resumed.returncode == 0, f"resumed harvest exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    compared = 0
    for key, folder in folders.items():
        for i in range(HARVEST["chunks"]):
            check((folder / f"{i}.npy").read_bytes() == (control[key] / f"{i}.npy").read_bytes(),
                  f"resumed chunk {i} of {key} differs from the uninterrupted harvest's")
            got, want = integrity.read_chunk_manifest(folder, i), integrity.read_chunk_manifest(control[key], i)
            check(got["files"] == want["files"], f"chunk {i} of {key}: manifest digests differ")
            compared += 1
    emit("harvest_resume", fault="kill:chunk_pair:chunk=1", killed_exit=killed.returncode, killed_s=killed_s,
         resumed_s=resumed_s, chunks_bit_equal=compared, cursor=read_harvest_cursor(first)["chunk"])


def phase_harvest_sweep(torch, root: Path, cfg, params, lang, store: Path):
    """`run_single_layer` over the harvested residual store, with no
    ``activation_width`` (`get_activation_size` gives 512): 16 tied members
    at ratio 8 in bf16, 3 x 32 steps. Counts set to 0 just before and read
    just after: K1 and K2 96 times each and nothing else. The export loads;
    on held-out harvested rows every member coding at least one feature a
    row (L0 >= 1) has FVU below 1, a member under one (the top of the l1
    grid, so early in training) has the zero reconstruction's FVU within
    1e-3, and the lowest-l1 member and at least half the grid are below 1.
    Returns the launches and the export (the serving phases load it)."""
    from sparse_coding__tpu_torch.data.activations import capture_fn
    from sparse_coding__tpu_torch.lm import make_tensor_name
    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.train import experiments as ex

    layer = HARVEST["layer"]
    held = []

    def builder(c, **kw):  # the default builder, its ensembles (and graph pools) kept for the read below
        res = ex.dense_l1_range_experiment(c, **kw)
        held.extend(res[0])
        return res

    name = make_tensor_name(layer, "residual")
    heldout = lang.sample(HARVEST["heldout_rows"], HARVEST["seq"], seed=HARVEST["heldout_seed"])
    sample = capture_fn(cfg, [name], layer + 1)(params, torch.from_numpy(heldout).cuda())[name]
    sample = sample.reshape(-1, cfg.d_model).float()
    out = root / "sweep_out"
    steps = HARVEST["chunks"] * harvest_chunk_rows(cfg) // HARVEST["sweep_batch"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mod in (tk, kk, fk):
        mod.reset_launches()
    t0 = time.perf_counter()
    lds = ex.run_single_layer(layer=layer, layer_loc="residual", ratio=HARVEST["ratio"], dtype="bfloat16",
                              dataset_folder=str(store), n_chunks=HARVEST["chunks"], n_epochs=1,
                              batch_size=HARVEST["sweep_batch"], output_folder=str(out), experiment=builder,
                              device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() - before
    torch.cuda.empty_cache()
    pools = graph_pool_bytes(torch)
    captures, capture_s = sum(e.captures for e, _, _ in held), sum(e.capture_seconds for e, _, _ in held)
    del held[:]
    want = dict.fromkeys(launches, 0)
    want.update(tied_sae_fwd=steps, tied_sae_bwd_adam=steps)
    check(launches == want, f"harvest sweep launches {launches}, want {want}")
    members = len(lds)
    check(members == 16 and {hp["dict_size"] for _, hp in lds} == {HARVEST["ratio"] * cfg.d_model},
          f"harvest sweep exported {members} dicts {[hp for _, hp in lds][:2]}")
    events = read_events(out / "events.jsonl")
    check([e["status"] for e in events if e["event"] == "run_end"] == ["ok"], "harvest sweep run_end")
    spans = {c: span_seconds(events, c) for c in ("step", "checkpoint", "data_wait")}
    loaded = ckpt_lib.load_learned_dicts(out / f"_{HARVEST['chunks'] - 1}" / "learned_dicts.pkl", verify=True)
    check(len(loaded) == members, f"{len(loaded)} dicts reloaded")
    metrics = evaluate_dicts([ld for ld, _ in loaded], sample)
    fvu, l0 = [m["fvu"] for m in metrics], [m["l0"] for m in metrics]
    l1 = [hp["l1_alpha"] for _, hp in loaded]
    # the top of the l1 grid nearly stops coding in so short a run (under one
    # feature a row): it reconstructs ~0, and its FVU is then E[x²] / Var(x),
    # which exceeds 1 by the activations' mean. Every member coding at least
    # a feature a row is below 1, as are the lowest-l1 member and half the grid
    zero_fvu = float(torch.mean(sample ** 2) / torch.mean((sample - sample.mean(dim=0)) ** 2))
    quiet = [i for i, v in enumerate(l0) if v < 1.0]
    check(all(math.isfinite(v) for v in fvu) and all(fvu[i] < 1.0 for i in range(members) if i not in quiet),
          f"held-out FVU {fvu} (L0 {l0})")
    check(all(abs(fvu[i] - zero_fvu) <= 1e-3 * zero_fvu for i in quiet),
          f"held-out FVU {fvu} of members under one feature a row, the zero reconstruction's {zero_fvu}")
    check(l1.index(min(l1)) not in quiet and len(quiet) <= members // 2, f"members under one feature a row {quiet}")
    activations = steps * HARVEST["sweep_batch"] * members
    emit("harvest_sweep", source="BASELINE configs 1/2: Pythia-70M layer-2 residual, 8x dictionary",
         builder="dense_l1_range_experiment", members=members, n_dict=HARVEST["ratio"] * cfg.d_model,
         width=cfg.d_model, batch=HARVEST["sweep_batch"], compute_dtype="bfloat16", steps=steps,
         cut="depth: 3 chunks of 65,536 rows, 1 epoch (run_single_layer: 20 chunks, 8 epochs)",
         launches={k: v for k, v in launches.items() if v}, wall_s=wall, activations_per_s=activations / wall,
         step_span_activations_per_s=activations / spans["step"], span_seconds=spans,
         peak_allocated_bytes=peak, graph_pool_bytes=None if pools is None else sum(pools.values()),
         captures=captures, capture_s=capture_s, heldout_rows=int(sample.shape[0]), l1=l1, fvu=fvu, l0=l0,
         members_fvu_below_1=sum(v < 1 for v in fvu), members_under_one_feature=quiet, zero_reconstruction_fvu=zero_fvu)
    del lds, loaded
    torch.cuda.empty_cache()
    return launches, out / f"_{HARVEST['chunks'] - 1}" / "learned_dicts.pkl"


def phase_harvest_kernels(torch, tk):
    """K1 and K2 at the harvest sweep's shape (`HARVEST_TIED`), against
    their plain versions, timed: kernels-line rows ``1h`` / ``3h``."""
    g = torch.Generator(device="cuda").manual_seed(1357)
    return tied_kernel_rows(torch, tk, g, HARVEST_TIED)


# -- the paper's evaluation (ROADMAP A8b): perplexity, ablation graphs, autointerp, toys --

def zero_launches(torch):
    """Every wrapper's launch count set to 0."""
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    for mod in (tk, kk, fk):
        mod.reset_launches()
    return lambda: {k: v for k, v in {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}.items() if v}


def timed(torch, fn):
    """``(fn(), seconds)`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eager_ablation_edges(torch, iv, params, cfg, loc, ld, tokens, ablate, targets, make_hook, read):
    """The ablation graph of one site written as a per-feature loop over the
    public hooks and `cache_all_activations(hooks=)`, the edges reduced with
    the module's reads: ``({edge: weight}, seconds)``."""
    models, name = {loc: ld}, iv.get_model_tensor_name(loc)
    t = torch.as_tensor(targets, device="cuda")
    base = read(iv.cache_all_activations(params, cfg, models, tokens, device="cuda")[loc][None], t)
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in ablate:
        acts = iv.cache_all_activations(params, cfg, models, tokens, hooks={name: make_hook(ld, f)}, device="cuda")
        rows.append(torch.abs(base - read(acts[loc][None], t))[0].mean(dim=0))
    w = torch.stack(rows).cpu().numpy()
    seconds = time.perf_counter() - t0
    edges = {((loc, f), (loc, g)): float(w[i, j]) for j, g in enumerate(targets) for i, f in enumerate(ablate)
             if f != g}
    return edges, seconds


def phase_evaluate_lm(torch, cfg, params, lang, export: Path):
    """`metrics/intervention.py` on the pretrained subject with the harvest
    sweep's 16 exported dicts at layer 2's residual, on 64 held-out
    sequences at the subject's pretraining length in batches of 16. Counts
    set to 0 just before each of its evaluation calls and read just after
    (the reference runs and the eager loops are left out): no hand-written
    kernel (JAX computes the path in plain XLA). `calculate_perplexity`: the identity
    dict within 1e-5 of the base loss, the lowest-FVU dict's loss below
    every zero-code member's (L0 < 1 on these rows), ``vmapped=True`` the
    bits of ``False``, and one batch of two dicts recomputed on the CPU
    within rtol 1e-4 (f32 sums in another order over a 50,304-word
    log-softmax). `cache_all_activations`: the bits of `run_with_cache` +
    encode. The two ablation graphs of the lowest-FVU dict on the first
    batch (non-positional: its 32 most active features, each ablated and
    read; positional: 4 positions × its 8 most active) equal the phase's
    eager per-feature loop bit for bit, and two calls each other (the ms a
    feature of both calls are printed: the first includes the process's
    first capture)."""
    import numpy as np

    from sparse_coding__tpu_torch.lm import model as lm_model
    from sparse_coding__tpu_torch.metrics import intervention as iv
    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts
    from sparse_coding__tpu_torch.models.learned_dict import Identity
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.utils.tree import tree_map

    loc = (HARVEST["layer"], "residual")
    seq = SUBJECT["corpus"][1]
    tokens = lang.sample(EVAL["rows"], seq, seed=EVAL["seed"])
    lds = ckpt_lib.load_learned_dicts(export, verify=True, device="cuda")
    name = iv.get_model_tensor_name(loc)
    with torch.inference_mode():
        _, cache = lm_model.forward(params, torch.from_numpy(tokens).cuda(), cfg, cache_names=[name],
                                    stop_at_layer=loc[0] + 1)
        metrics = evaluate_dicts([ld for ld, _ in lds], cache[name].reshape(-1, cfg.d_model))
    del cache
    fvu, l0 = [m["fvu"] for m in metrics], [m["l0"] for m in metrics]
    dicts = lds + [(Identity(cfg.d_model, device="cuda"), {"name": "identity"})]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    launches = {}

    def count(read_launches):
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v

    read_launches = zero_launches(torch)
    (base, results), seconds = timed(torch, lambda: iv.calculate_perplexity(
        params, cfg, dicts, loc, tokens, batch_size=EVAL["batch"], device="cuda"))
    (base_s, results_s), seconds_s = timed(torch, lambda: iv.calculate_perplexity(
        params, cfg, dicts, loc, tokens, batch_size=EVAL["batch"], vmapped=False, device="cuda"))
    count(read_launches)
    peak = torch.cuda.max_memory_allocated() - before
    check(base == base_s and results == results_s, "calculate_perplexity: vmapped=True is not the bits of False")
    losses = [v for _, v in results]
    check(all(math.isfinite(v) for v in [base] + losses), f"losses {base} {losses}")
    check(abs(losses[-1] - base) < 1e-5, f"identity dict's loss {losses[-1]} vs the base {base}")
    best = int(np.argmin(fvu))
    quiet = [i for i, v in enumerate(l0) if v < 1.0]
    check(quiet and all(losses[best] < losses[i] for i in quiet),
          f"lowest-FVU dict {best}'s loss {losses[best]} not below the zero-code members' {[losses[i] for i in quiet]}")

    # one batch and two dicts recomputed on the CPU
    pick = [best, quiet[0]]
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_lds = ckpt_lib.load_learned_dicts(export, verify=True, device="cpu")
    batch0 = tokens[: EVAL["batch"]]
    card = [float(iv.perplexity_under_reconstruction(params, cfg, lds[i][0], loc, batch0, device="cuda"))
            for i in pick]
    cpu = [float(iv.perplexity_under_reconstruction(cpu_params, cfg, cpu_lds[i][0], loc, batch0, device="cpu"))
           for i in pick]
    del cpu_params, cpu_lds
    cpu_rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    check(max(cpu_rel) <= EVAL["cpu_rtol"], f"card vs CPU losses {card} {cpu}")

    # cache_all_activations against run_with_cache + encode
    ld = lds[best][0]
    models = {loc: ld}
    tok0 = torch.from_numpy(batch0).cuda()
    read_launches = zero_launches(torch)
    codes = iv.cache_all_activations(params, cfg, models, batch0, device="cuda")[loc]
    count(read_launches)
    with torch.inference_mode():
        _, cache = lm_model.run_with_cache(params, tok0, cfg, [name])
        want = ld.encode(cache[name].reshape(-1, cfg.d_model)).reshape(codes.shape)
    check(torch.equal(codes, want), "cache_all_activations differs from run_with_cache + encode")
    order = torch.argsort(codes.mean(dim=(0, 1)), descending=True, stable=True).tolist()
    del cache, want

    graphs = {}
    for kind, ablate, make_hook, read, build in (
        ("non_positional", order[: EVAL["ablate"]], iv.ablate_feature_intervention_non_positional,
         iv._read_feature_non_positional, iv.build_ablation_graph_non_positional),
        ("positional", [(p, f) for p in EVAL["positions"] for f in order[: EVAL["pos_feats"]]],
         iv.ablate_feature_intervention, iv._read_feature_positional, iv.build_ablation_graph),
    ):
        def run():
            return build(params, cfg, models, batch0, features_to_ablate={loc: ablate},
                         target_features={loc: ablate}, device="cuda")

        read_launches = zero_launches(torch)
        first, first_s = timed(torch, run)
        graph, g_s = timed(torch, run)
        count(read_launches)
        eager, e_s = eager_ablation_edges(torch, iv, params, cfg, loc, ld, tok0, ablate, ablate, make_hook, read)
        check(graph == first, f"{kind} ablation graph differs between two calls")
        check(len(graph) == len(ablate) * (len(ablate) - 1), f"{kind} graph has {len(graph)} edges")
        check(set(graph) == set(eager) and all(graph[k] == eager[k] for k in graph),
              f"{kind} ablation graph differs from the eager per-feature loop")
        vals = np.asarray(list(graph.values()))
        check(bool(np.isfinite(vals).all() and (vals >= 0).all() and (vals > 0).any()), f"{kind} edges {vals[:8]}")
        graphs[kind] = dict(ablated=len(ablate), edges=len(graph), ms_per_feature=g_s / len(ablate) * 1e3,
                            first_call_ms_per_feature=first_s / len(ablate) * 1e3,
                            eager_loop_ms_per_feature=e_s / len(ablate) * 1e3, max_edge=float(vals.max()),
                            nonzero_edges=int((vals > 0).sum()))
    check(not launches, f"the evaluation launched hand-written kernels {launches}")
    tokens_scored = (EVAL["rows"] // EVAL["batch"]) * EVAL["batch"] * seq
    emit("evaluate_lm", model=SUBJECT["model"], location=list(loc), dicts=len(lds), rows=EVAL["rows"], seq=seq,
         batch=EVAL["batch"], launches=launches, base_loss=base, losses=losses[:-1], identity_loss=losses[-1],
         fvu=fvu, l0=l0, lowest_fvu_dict=best, zero_code_members=quiet,
         perplexity_s=seconds, perplexity_per_dict_s=seconds_s,
         edited_forwards_per_s=len(dicts) * tokens_scored / seq / EVAL["batch"] / seconds,
         edited_tokens_per_s=len(dicts) * tokens_scored / seconds, peak_allocated_bytes=peak,
         cpu_check=dict(dicts=pick, card=card, cpu=cpu, max_rel=max(cpu_rel), rtol=EVAL["cpu_rtol"]),
         cache_all_activations_bit_equal=True, ablation=graphs)


def phase_interp_codes(torch, cfg, params, lang, export: Path):
    """`interp/pipeline.py::make_feature_activation_datasets` (capture and
    encode on the card, the frames on the host) for the harvest sweep's 16
    dicts over 256 fragments of `OPENAI_FRAGMENT_LEN` tokens, the CLI's 200
    kept features: each frame's activation columns the bits of its dict's
    own capture forward + encode. Counts set to 0 around the call: no
    hand-written kernel. The device half alone (`_fragment_codes`) is timed
    after it as a split. Also says whether pandas and pyarrow (the frames,
    the parquet cache) import on this machine."""
    import importlib

    import numpy as np

    from sparse_coding__tpu_torch.interp import pipeline
    from sparse_coding__tpu_torch.interp.records import OPENAI_FRAGMENT_LEN
    from sparse_coding__tpu_torch.lm import model as lm_model
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib

    for package in ("pandas", "pyarrow"):
        try:
            version = importlib.import_module(package).__version__
        except ImportError as e:
            emit("interp_import", package=package, imports=False, error=str(e))
        else:
            emit("interp_import", package=package, imports=True, version=version)
    layer, kept, n, L = HARVEST["layer"], INTERP["max_features"], INTERP["fragments"], OPENAI_FRAGMENT_LEN
    lds = [ld for ld, _ in ckpt_lib.load_learned_dicts(export, verify=True, device="cuda")]
    fragments = lang.sample(n, L, seed=INTERP["seed"])

    def decode(row):
        return [str(int(t)) for t in row]

    kw = dict(max_features=kept, batch_size=INTERP["batch"], device="cuda")
    pipeline.make_feature_activation_datasets(params, cfg, lds[:1], layer, "residual",  # warm-up
                                              fragments[: INTERP["batch"]], decode, **kw)
    read_launches = zero_launches(torch)
    frames, seconds = timed(torch, lambda: pipeline.make_feature_activation_datasets(
        params, cfg, lds, layer, "residual", fragments, decode, **kw))
    launches = read_launches()
    check(not launches, f"the interp pipeline launched hand-written kernels {launches}")
    codes, device_s = timed(torch, lambda: pipeline._fragment_codes(params, cfg, lds, layer, "residual", fragments,
                                                                    **kw))
    columns = [f"feature_{i}_activation_{j}" for i in range(kept) for j in range(L)]
    name = lm_model.make_tensor_name(layer, "residual")
    toks = torch.from_numpy(fragments).cuda()
    with torch.inference_mode():
        for d, ld in enumerate(lds):
            parts = []
            for s in range(0, n, INTERP["batch"]):
                _, cache = lm_model.forward(params, toks[s : s + INTERP["batch"]], cfg, cache_names=[name],
                                            stop_at_layer=layer + 1)
                acts = cache[name]
                parts.append(ld.encode(acts.reshape(-1, cfg.d_model)).reshape(*acts.shape[:2], -1)[:, :, :kept])
            want = torch.cat(parts).cpu().numpy()  # [n, L, kept]
            df = frames[d]
            check(df.shape == (n, 1 + kept * (L + 2))
                  and list(df["fragment_token_strs"]) == [decode(r) for r in fragments]
                  and np.array_equal(df[columns].to_numpy(), np.transpose(want, (0, 2, 1)).reshape(n, kept * L))
                  and np.array_equal(df[[f"feature_{i}_max" for i in range(kept)]].to_numpy(), want.max(axis=1)),
                  f"dict {d}'s activation frame differs from its own capture + encode")
            check(np.array_equal(codes[d], want), f"dict {d}'s device-half codes differ from its own capture + encode")
    emit("interp_codes", dicts=len(lds), fragments=n, fragment_len=L, batch=INTERP["batch"], max_features=kept,
         launches=launches, seconds=seconds, fragments_per_s=n / seconds, dict_frames_per_s=n * len(lds) / seconds,
         device_half_s=device_s, device_half_fragments_per_s=n / device_s,
         bit_equal_dicts=len(lds), host_bytes=int(sum(c.nbytes for c in codes)))


def phase_toy_grid(torch):
    """`train/toy_models.py::run_toy_grid` at `ToyArgs`' own widths (256 →
    dict ratios 2..64, N 512..16384; 512 ground-truth features, batch 4096,
    the default l1 row) for `TOY["epochs"]` epochs: the MMCS and dead grids
    and the seconds, MMCS finite and in [0, 1]. Then `run_single_go` on the
    card and on the CPU from the same params (built on the CPU, moved) and
    the same batches (drawn on the CPU, replayed) for a few steps: MMCS
    within 1e-4 and the dead counts within 1% of N (f32 sums in another
    order, amplified where Adam meets gradients near 0)."""
    import numpy as np

    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
    from sparse_coding__tpu_torch.ensemble import _map_tensors
    from sparse_coding__tpu_torch.train import toy_models
    from sparse_coding__tpu_torch.utils.config import ToyArgs

    cfg = ToyArgs(epochs=TOY["epochs"])
    read_launches = zero_launches(torch)
    grids, seconds = timed(torch, lambda: toy_models.run_toy_grid(cfg, device="cuda"))
    launches = read_launches()
    check(not launches, f"the toy grid launched hand-written kernels {launches}")
    mmcs = grids["mmcs"]
    check(mmcs.shape == (1, 6) and bool(np.isfinite(mmcs).all() and ((mmcs >= 0) & (mmcs <= 1)).all()),
          f"toy MMCS grid {mmcs}")

    small = ToyArgs(**TOY["single"])
    cpu_gen = RandomDatasetGenerator(small.activation_dim, small.n_ground_truth_components, small.batch_size,
                                     small.feature_num_nonzero, small.feature_prob_decay, False, key=small.seed,
                                     device="cpu")
    batches = [next(cpu_gen) for _ in range(small.epochs + 10)]
    real = toy_models.build_ensemble

    def on_cpu_then_moved(sig, key, hparams, device=None, **kw):
        ens = real(sig, key, hparams, device="cpu", **kw)
        ens.state = _map_tensors(ens.state, lambda t: t.to(device))
        return ens

    class Replay:
        def __init__(self, device):
            self._it = iter([b.to(device) for b in batches])
            self.feats = cpu_gen.feats.to(device)

        def __next__(self):
            return next(self._it)

    toy_models.build_ensemble = on_cpu_then_moved
    try:
        (ld_c, mmcs_c, dead_c), single_s = timed(torch, lambda: toy_models.run_single_go(small, Replay("cuda"),
                                                                                         device="cuda"))
        ld_h, mmcs_h, dead_h = toy_models.run_single_go(small, Replay("cpu"), device="cpu")
    finally:
        toy_models.build_ensemble = real
    dec_diff = float((ld_c.decoder.cpu() - ld_h.decoder).abs().max())
    check(abs(mmcs_c - mmcs_h) <= 1e-4 and abs(dead_c - dead_h) <= 0.01 * small.n_components_dictionary,
          f"run_single_go card vs CPU: MMCS {mmcs_c} / {mmcs_h}, dead {dead_c} / {dead_h}")
    steps = TOY["epochs"] * mmcs.shape[1]
    emit("toy_grid", activation_dim=cfg.activation_dim, n_ground_truth=cfg.n_ground_truth_components,
         batch=cfg.batch_size, epochs=cfg.epochs, l1_range=grids["l1_range"].tolist(),
         ratio_range=grids["ratio_range"].tolist(), mmcs=mmcs.tolist(), n_dead=grids["n_dead"].tolist(),
         launches=launches, seconds=seconds, steps=steps, steps_per_s=steps / seconds,
         single_go=dict(cfg=TOY["single"], seconds=single_s, mmcs_card=mmcs_c, mmcs_cpu=mmcs_h, dead_card=dead_c,
                        dead_cpu=dead_h, decoder_max_abs_diff=dec_diff))


# -- the remaining single-card paths: blockwise harvest (A5r), big batch (A6a), experiments (A8c) --

def phase_blockwise_harvest(torch, root: Path, cfg, params, lang):
    """`lm/ring_attention.py::blockwise_attention` on the pretrained subject.
    At seq 8192, batch 1: the attention of random [1, 8192, 8, 64] q/k/v
    against dense attention (JAX's pin, atol 2e-5), then layer 2's residual
    captured through `capture_fn(attn="blockwise")` against the dense
    capture (JAX's pin on a capture, atol 2e-3), each timed with its peak
    allocated bytes. Then `make_activation_dataset(attn="blockwise")` over 2
    sequences of 32768 tokens into a store of 2 chunks (dense attention's
    f32 scores alone would be 8 x 32768² x 4 B ≈ 34 GB a layer): every row
    finite, and the first 8192 positions of the first sequence within 2e-3
    of their capture at seq 8192 (causal: later tokens cannot change them).
    Counts set to 0 around the phase: no hand-written kernel."""
    import numpy as np

    from sparse_coding__tpu_torch.data.activations import capture_fn, make_activation_dataset
    from sparse_coding__tpu_torch.lm import make_tensor_name
    from sparse_coding__tpu_torch.lm.model import dense_attention
    from sparse_coding__tpu_torch.lm.ring_attention import blockwise_attention

    S, L, layer = BLOCKWISE["seq"], BLOCKWISE["long_seq"], HARVEST["layer"]
    read_launches = zero_launches(torch)
    g = torch.Generator(device="cuda").manual_seed(BLOCKWISE["attn_seed"])
    q, k, v = (torch.randn((1, S, cfg.n_heads, cfg.d_head), generator=g, device="cuda") for _ in range(3))
    attn_err = float((dense_attention(q, k, v) - blockwise_attention()(q, k, v)).abs().max())
    check(attn_err <= BLOCKWISE["attn_atol"], f"blockwise attention at seq {S}: max |Δ| {attn_err} vs dense")
    del q, k, v
    name = make_tensor_name(layer, "residual")
    tokens = lang.sample(BLOCKWISE["long_chunks"], L, seed=BLOCKWISE["tokens_seed"])
    short = torch.from_numpy(tokens[:1, :S]).cuda()

    def capture(attn):
        fn = capture_fn(cfg, [name], layer + 1, attn=attn)
        fn(params, short[:, :512])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, seconds = timed(torch, lambda: fn(params, short)[name])
        return out, seconds, torch.cuda.max_memory_allocated() - before

    dense, dense_s, dense_peak = capture("dense")
    block, block_s, block_peak = capture("blockwise")
    cap_err = float((dense.float() - block.float()).abs().max())
    check(cap_err <= BLOCKWISE["capture_atol"], f"blockwise capture at seq {S}: max |Δ| {cap_err} vs dense")
    del dense
    chunk_gb = L * cfg.d_model * 2 / 1024**3  # one sequence a chunk
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    folders, long_s = timed(torch, lambda: make_activation_dataset(
        params, cfg, tokens, root / "long", [layer], ["residual"], batch_size=1, chunk_size_gb=chunk_gb,
        attn="blockwise", device="cuda"))
    long_peak = torch.cuda.max_memory_allocated() - before
    launches = read_launches()
    check(not launches, f"the blockwise harvest launched hand-written kernels {launches}")
    folder = folders[(layer, "residual")]
    for i in range(BLOCKWISE["long_chunks"]):
        arr = np.load(folder / f"{i}.npy", mmap_mode="r")
        check(arr.shape == (L, cfg.d_model) and arr.dtype == np.float16 and bool(np.isfinite(arr).all()),
              f"long chunk {i}: {arr.shape} {arr.dtype}")
    first = torch.from_numpy(np.load(folder / "0.npy")[:S]).cuda().float()
    prefix_err = float((first - block[0].float()).abs().max())
    check(prefix_err <= BLOCKWISE["capture_atol"], f"the long harvest's first {S} rows differ by {prefix_err}")
    del block, first
    emit("blockwise_harvest", layer=layer, loc="residual", q_block=512, kv_block=512, compute_dtype="float32",
         attention_max_abs_err=attn_err, attention_atol=BLOCKWISE["attn_atol"], capture_max_abs_err=cap_err,
         capture_atol=BLOCKWISE["capture_atol"], seq=S, dense_s=dense_s, dense_tokens_per_s=S / dense_s,
         dense_peak_allocated_bytes=dense_peak, blockwise_s=block_s, blockwise_tokens_per_s=S / block_s,
         blockwise_peak_allocated_bytes=block_peak, long_seq=L, long_chunks=BLOCKWISE["long_chunks"],
         long_s=long_s, long_tokens_per_s=tokens.size / long_s, long_peak_allocated_bytes=long_peak,
         long_prefix_max_abs_err=prefix_err, dense_scores_bytes_at_long_seq=cfg.n_heads * L * L * 4,
         launches=launches)


def big_batch_train(data, n_steps: int, **kw):
    """`train_big_batch` of a tied SAE on ``data`` (the harvested store's
    folder, or its rows on the card) at `BIG_BATCH`'s hyperparameters and
    Pythia-70M's width, on the card (module level: the preemption workers
    run the same one)."""
    from sparse_coding__tpu_torch.lm import config_for
    from sparse_coding__tpu_torch.models import FunctionalTiedSAE
    from sparse_coding__tpu_torch.train.big_batch import train_big_batch

    d = config_for(SUBJECT["model"]).d_model
    hp = dict(activation_size=d, n_dict_components=BIG_BATCH["ratio"] * d, l1_alpha=BIG_BATCH["l1"])
    data = str(data) if isinstance(data, Path) else data
    return train_big_batch(FunctionalTiedSAE, hp, data, BIG_BATCH["batch"], n_steps, BIG_BATCH["seed"],
                           learning_rate=BIG_BATCH["lr"], reinit_every=BIG_BATCH["reinit_every"], device="cuda", **kw)


def big_batch_worker(argv) -> int:
    """``chip_smoke.py --big-batch-worker <store> <ckpt_dir> <out.pt>
    [--resume]``: the `big_batch` phase's run as a process of its own
    (``SC_FAULT`` from the environment), its final params saved."""
    import torch

    state, _ = big_batch_train(argv[0], BIG_BATCH["steps"], checkpoint_dir=argv[1], resume="--resume" in argv[3:])
    torch.save({k: v.cpu() for k, v in state.params.items()}, argv[2])
    return 0


def phase_big_batch(torch, root: Path, store: Path):
    """`train/big_batch.py::train_big_batch` of a tied SAE on the harvested
    layer-2 residual store (a folder: `load_store_dataset`), ratio 32 (N
    16384), l1 1e-3, batch 4096, lr 3e-4, f32, 450 steps with a resurrection
    every 100 (cut from RESURRECT_r04's 400): the resurrection log at
    100..400, the export's FVU and L0 on 16,384 rows of the store (finite;
    printed: 50 steps after resurrecting thousands of features the new rows
    still fire widely). The device time of a step alone (eager steps and
    their MSE back to back, CUDA events) against the run's wall gives the
    host share. 50 steps in bf16 compute: finite, its MSE within half the
    f32 arm's (`tests/test_train_drivers.py`'s bound), beside the zero
    reconstruction's. A worker SIGTERMed in step 200
    (``SC_FAULT=sigterm:step=199``: exit 75, its checkpoint at the step-200
    resurrection boundary, where the ring is empty), then resumed in
    another: its final params are the uninterrupted run's bits. At the CPU
    tests' shape (D 24, N 48, B 256, 30 steps, resurrection every 10) the
    card's run against the CPU's from the same key and rows: the same
    resurrection steps, params within 30 x lr (Adam moves an element by at
    most ~lr a step, so f32 sums in another order stay inside it). Counts
    set to 0 around the phase: no hand-written kernel."""
    import numpy as np

    from sparse_coding__tpu_torch.data.chunks import load_store_dataset
    from sparse_coding__tpu_torch.metrics.standard import fraction_variance_unexplained, sparsity_l0
    from sparse_coding__tpu_torch.models import FunctionalTiedSAE
    from sparse_coding__tpu_torch.telemetry.events import RunTelemetry
    from sparse_coding__tpu_torch.train import big_batch as bb
    from sparse_coding__tpu_torch.utils.optim import adam

    steps, B = BIG_BATCH["steps"], BIG_BATCH["batch"]
    read_launches = zero_launches(torch)
    log = []
    tel = RunTelemetry()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    try:
        (state, sig), wall = timed(torch, lambda: big_batch_train(store, steps, resurrection_log=log, telemetry=tel))
    finally:
        tel.close()
    peak = torch.cuda.max_memory_allocated() - before
    counters = {k: v for k, v in tel.counters.items() if k in ("train.steps", "resurrections", "resurrected_features")}
    load_s = tel.counters.get("span.data_wait.seconds", 0.0)
    ld = sig.to_learned_dict(state.params, state.buffers)
    dataset, _ = load_store_dataset(store, device="cuda")
    idx = torch.from_numpy(np.random.default_rng(BIG_BATCH["sample_seed"]).choice(
        dataset.shape[0], BIG_BATCH["sample"], replace=False)).cuda()
    sample = dataset[idx]
    fvu, l0 = float(fraction_variance_unexplained(ld, sample)), float(sparsity_l0(ld, sample))
    zero_mse = float((sample ** 2).mean())
    emit("big_batch_run", steps=steps, resurrection_log=log, counters=counters, wall_s=wall, load_store_s=load_s,
         step_ms=1e3 * (wall - load_s) / steps, export_fvu=fvu, export_l0=l0, peak_allocated_bytes=peak)
    check([s for s, _ in log] == [100, 200, 300, 400], f"resurrection log {log}")
    check(counters.get("train.steps") == steps and counters.get("resurrections") == 4, f"counters {counters}")
    check(math.isfinite(fvu) and math.isfinite(l0), f"big-batch export FVU {fvu}, L0 {l0}")

    # the device time of a step alone: eager steps with no host read between
    # them, CUDA events around them (the host enqueues faster than the card runs)
    gen = torch.Generator().manual_seed(0)
    hp = dict(activation_size=dataset.shape[1], n_dict_components=BIG_BATCH["ratio"] * dataset.shape[1],
              l1_alpha=BIG_BATCH["l1"])
    params, buffers = FunctionalTiedSAE.init(gen, **hp, device="cpu")
    tx = adam(BIG_BATCH["lr"])
    params = {k: v.cuda() for k, v in params.items()}
    buffers = {k: (v.cuda() if v is not None else None) for k, v in buffers.items()}
    st = bb.BigBatchState(params, buffers, bb.init_opt_state(tx, params), torch.zeros(params["encoder"].shape[0],
                          device="cuda"), torch.zeros((), dtype=torch.int32, device="cuda"))
    step = bb.make_big_batch_step(FunctionalTiedSAE, tx)
    x = dataset[torch.randint(0, dataset.shape[0], (B,), generator=gen).cuda()]

    def one_step():
        _, _, c = step(st, x)
        bb.per_example_mse_from_codes(FunctionalTiedSAE, st.params, st.buffers, x, c)

    device_ms = time_ms(torch, one_step, reps=20, warmup=3)
    host_share = max(0.0, 1.0 - steps * device_ms / 1e3 / (wall - load_s))
    del st, params, buffers, x

    # bf16 compute, 50 steps, against an f32 arm of the same length
    (s16, _), bf16_s = timed(torch, lambda: big_batch_train(dataset, BIG_BATCH["bf16_steps"], compute_dtype="bfloat16"))
    (s32, _), f32_s = timed(torch, lambda: big_batch_train(dataset, BIG_BATCH["bf16_steps"]))
    mse = {}
    for arm, st in (("bf16", s16), ("f32", s32)):
        x = sample[:512]
        mse[arm] = float(((sig.to_learned_dict(st.params, st.buffers).predict(x) - x) ** 2).mean())
    check(all(math.isfinite(v) for v in mse.values()) and abs(mse["bf16"] - mse["f32"]) < 0.5 * max(mse["f32"], 1e-6),
          f"bf16 arm MSE {mse}")
    del s16, s32, dataset

    # preempted at the step-200 resurrection boundary, resumed: the same bits
    def worker(*extra, fault=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
        if fault:
            env["SC_FAULT"] = fault
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--big-batch-worker", str(store),
                               str(root / "bb_ckpt"), str(root / "bb_resumed.pt"), *extra], env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - t

    fault = f"sigterm:step={BIG_BATCH['fault_step']}"
    killed, killed_s = worker(fault=fault)
    check(killed.returncode == 75, f"preempted big-batch run exited {killed.returncode}: {killed.stderr[-3000:]}")
    ckpts = sorted(p.name for p in (root / "bb_ckpt").glob("ckpt_*"))
    check(ckpts == [f"ckpt_{BIG_BATCH['fault_step'] + 1}"], f"checkpoints after the SIGTERM: {ckpts}")
    resumed, resumed_s = worker("--resume")
    check(resumed.returncode == 0, f"resumed big-batch run exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    got = torch.load(root / "bb_resumed.pt", weights_only=True)
    for k, v in state.params.items():
        check(torch.equal(got[k], v.cpu()), f"resumed {k} differs from the uninterrupted run's")

    # the CPU tests' shape on the card and on the CPU, same key and rows
    sm = BIG_BATCH["small"]
    data = np.random.default_rng(sm["seed"]).standard_normal((sm["rows"], sm["D"])).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        slog = []
        st, _ = bb.train_big_batch(FunctionalTiedSAE, dict(activation_size=sm["D"], n_dict_components=sm["N"],
                                                           l1_alpha=sm["l1"]), data, sm["B"], sm["steps"],
                                   sm["seed"], learning_rate=sm["lr"], reinit_every=sm["reinit_every"],
                                   resurrection_log=slog, device=dev)
        runs[dev] = (st, slog)
    small_err = max(float((runs["cuda"][0].params[k].cpu() - runs["cpu"][0].params[k]).abs().max())
                    for k in runs["cpu"][0].params)
    small_tol = sm["steps"] * sm["lr"]
    check([s for s, _ in runs["cuda"][1]] == [s for s, _ in runs["cpu"][1]] and small_err <= small_tol,
          f"card vs CPU at the test shape: logs {runs['cuda'][1]} / {runs['cpu'][1]}, max |Δ| {small_err}")
    launches = read_launches()
    check(not launches, f"the big-batch trainer launched hand-written kernels {launches}")
    activations = steps * B
    emit("big_batch", source="RESURRECT_r04.json (ratio 32, l1 1e-3, batch 4096, lr 3e-4) at Pythia-70M layer 2",
         width=int(state.params["encoder"].shape[1]), n_dict=int(state.params["encoder"].shape[0]), batch=B,
         lr=BIG_BATCH["lr"], l1=BIG_BATCH["l1"], compute_dtype="float32", steps=steps,
         reinit_every=BIG_BATCH["reinit_every"],
         cut="reinit_every 400 -> 100, 450 steps (four resurrections, 50 steps after the last)",
         resurrection_log=log, counters=counters, wall_s=wall, load_store_s=load_s,
         step_ms=1e3 * (wall - load_s) / steps, activations_per_s=activations / (wall - load_s),
         device_step_ms=device_ms,
         host_share=host_share, peak_allocated_bytes=peak, export_fvu=fvu, export_l0=l0,
         fvu_rows=f"{BIG_BATCH['sample']} rows drawn from the store", bf16_steps=BIG_BATCH["bf16_steps"],
         bf16_s=bf16_s, f32_s=f32_s, bf16_vs_f32_mse=mse, zero_reconstruction_mse=zero_mse,
         resume=dict(fault=fault, preempted_exit=killed.returncode, preempted_s=killed_s, checkpoint=ckpts[0],
                     resumed_s=resumed_s, bit_equal_params=len(got)),
         small=dict(shape=sm, max_abs_err=small_err, tolerance=small_tol, log_card=runs["cuda"][1],
                    log_cpu=runs["cpu"][1]),
         launches=launches)


def phase_paper_experiments(torch, cfg, params, lang, export: Path, store: Path):
    """The device halves of `experiments/` on the pretrained subject and the
    harvest sweep's 16 dicts: `pca_perplexity_scores` (the PCA of 65,536
    harvested rows; 16 dicts + 32 noise magnitudes + 32 dynamic and 32
    static PCA dicts at pca_step 8 = 112 dicts x 4 batches of 16 x 128),
    `embedding_cosine_scores` (the 50,304-row embedding and unembedding
    against every dict), `investigate_scores` (dict 0 against dict 1),
    `feature_activations` (one feature over 256 fragments of 64 tokens, as
    `feature_case_study` runs it), `dict_compare` and
    `inter_dict_connections` (on 2,048 harvested rows) between dicts 0 and
    1; each timed. Checks: the zero-noise dict's FVU ~0 and its loss the
    identity's, the static PCA's FVU falling with its components, every
    score finite. Then card against CPU on small inputs (the CPU copies of
    the params and two dicts): the edited-forward loss of 2 dicts on 2
    sequences within rtol 1e-4 (f32 sums over a 50,304-word log-softmax),
    the cosines within 1e-5, the investigate scores within 1e-5 of each
    array's max (ENN runs to the hundreds), 8 fragments' activations within
    1e-4 of their max, the matched similarities within 1e-5. Counts set to 0 around the phase: no hand-written kernel."""
    import numpy as np

    from sparse_coding__tpu_torch import experiments as ex
    from sparse_coding__tpu_torch.data.chunks import ChunkStore
    from sparse_coding__tpu_torch.experiments.investigate import investigate_summary
    from sparse_coding__tpu_torch.lm import model as lm_model
    from sparse_coding__tpu_torch.metrics.intervention import mean_reconstruction_loss
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.utils import pickles
    from sparse_coding__tpu_torch.utils.tree import tree_map

    layer, loc = HARVEST["layer"], (HARVEST["layer"], "residual")
    loaded = ckpt_lib.load_learned_dicts(export, verify=True, device="cuda")
    lds = [ld for ld, _ in loaded]
    read_launches = zero_launches(torch)
    acts = ChunkStore(store).load(0, device="cuda")[: PAPER["pca_rows"]]
    tokens = lang.sample(*PAPER["tokens"], seed=PAPER["tokens_seed"])
    kw = dict(n_sample=PAPER["n_sample"], pca_step=PAPER["pca_step"], token_batch=PAPER["token_batch"], device="cuda")
    scores, pca_s = timed(torch, lambda: ex.pca_perplexity_scores(params, cfg, loc, tokens, acts,
                                                                  {"SAE": loaded}, **kw))
    n_dicts = sum(len(v) for v in scores.values())
    n_batches = PAPER["tokens"][0] // PAPER["token_batch"]
    check(n_dicts == 16 + 32 + 2 * len(range(1, cfg.d_model // 2, PAPER["pca_step"])),
          f"{n_dicts} dicts scored: {[(k, len(v)) for k, v in scores.items()]}")
    check(all(math.isfinite(a) and math.isfinite(b) for pts in scores.values() for a, b in pts), "non-finite score")
    noise0 = scores["Added Noise"][0]
    static = [f for f, _ in scores["PCA (static)"]]
    check(noise0[0] < 1e-5 and static[0] > static[-1], f"zero-noise FVU {noise0}, static PCA FVUs {static[:3]}..")
    with torch.inference_mode():
        base = float(np.mean([float(lm_model.lm_loss(params, torch.from_numpy(b).cuda(), cfg))
                              for b in tokens.reshape(n_batches, -1, tokens.shape[1])]))
    check(abs(noise0[1] - base) <= 1e-4 * base, f"zero-noise loss {noise0[1]} vs the unedited loss {base}")

    dict_sets = {layer: [(str(i), ld) for i, ld in enumerate(lds)]}
    cos, cos_s = timed(torch, lambda: ex.embedding_cosine_scores(params, dict_sets))
    check(all(0.0 <= e <= 1.0 and 0.0 <= u <= 1.0 for _, e, u in cos[layer]), f"embedding cosines {cos}")
    (mcs, ent, enn), inv_s = timed(torch, lambda: ex.investigate_scores(lds[0], lds[1]))
    summary = {k: (None if isinstance(v, float) and math.isnan(v) else v)  # no NaN in the JSON line
               for k, v in investigate_summary(mcs, ent, enn).items()}
    fragments = lang.sample(*PAPER["fragments"], seed=PAPER["fragments_seed"])
    per_tok, case_s = timed(torch, lambda: ex.feature_activations(params, cfg, lds[0], layer, "residual", fragments,
                                                                 PAPER["feature"]))
    study = ex.feature_case_study(params, cfg, lds[0], layer, "residual", fragments,
                                  lambda row: [str(int(t)) for t in row], PAPER["feature"])
    check(per_tok.shape == fragments.shape and bool(np.isfinite(per_tok).all())
          and len(study["top_logit_tokens"]) == 10, f"case study {per_tok.shape}")
    cmp, cmp_s = timed(torch, lambda: ex.dict_compare(lds[0], lds[1]))
    rows = acts[: PAPER["connections_rows"]]
    conn, conn_s = timed(torch, lambda: ex.inter_dict_connections(lds[0], lds[1], rows, rows))
    check(bool(np.isfinite(cmp["matched_sims"]).all()) and conn["correlation"].shape == (lds[0].n_feats,
                                                                                          lds[1].n_feats),
          "dict_compare / inter_dict_connections")
    launches = read_launches()
    check(not launches, f"the experiments launched hand-written kernels {launches}")

    # card against CPU on small inputs
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_lds = [pickles.loads(pickles.dumps(ld), device="cpu") for ld in lds[:2]]
    small_toks = tokens[: PAPER["small_rows"]][None]
    losses = {dev: [mean_reconstruction_loss(p, cfg, ld, loc, small_toks, device=dev) for ld in d]
              for dev, p, d in (("cuda", params, lds[:2]), ("cpu", cpu_params, cpu_lds))}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cos_c = ex.embedding_cosine_scores(cpu_params, {layer: [("0", cpu_lds[0]), ("1", cpu_lds[1])]})[layer]
    cos_err = max(abs(a - b) for r, c in zip(cos[layer][:2], cos_c) for a, b in zip(r[1:], c[1:]))
    inv_c = ex.investigate_scores(cpu_lds[0], cpu_lds[1])
    inv_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip((mcs, ent, enn), inv_c))
    small_frag = fragments[: PAPER["small_fragments"]]
    fa = ex.feature_activations(params, cfg, lds[0], layer, "residual", small_frag, PAPER["feature"])
    fc = ex.feature_activations(cpu_params, cfg, cpu_lds[0], layer, "residual", small_frag, PAPER["feature"])
    frag_err = float(np.abs(fa - fc).max()) / max(float(np.abs(fc).max()), 1e-12)
    cmp_c = ex.dict_compare(cpu_lds[0], cpu_lds[1])
    sims_err = float(np.abs(np.sort(cmp["matched_sims"]) - np.sort(cmp_c["matched_sims"])).max())
    check(loss_rel <= 1e-4 and cos_err <= 1e-5 and inv_err <= 1e-5 and frag_err <= 1e-4 and sims_err <= 1e-5,
          f"card vs CPU: loss rel {loss_rel}, cosines {cos_err}, investigate {inv_err}, fragments {frag_err}, "
          f"matched sims {sims_err}")
    forwards = n_dicts * n_batches
    emit("paper_experiments", dicts=len(lds), pca_rows=int(acts.shape[0]), pca_step=PAPER["pca_step"],
         scored_dicts=n_dicts, token_batches=n_batches, tokens=list(PAPER["tokens"]), pca_perplexity_s=pca_s,
         edited_forwards=forwards, edited_forwards_per_s=forwards / pca_s, base_loss=base,
         zero_noise=list(noise0), sae_scores=scores["SAE"], embedding_cosine_s=cos_s,
         embed_vocab=int(params["embed"].shape[0]), investigate_s=inv_s, investigate=summary,
         case_study_s=case_s, case_study_fragments=list(PAPER["fragments"]), dict_compare_s=cmp_s,
         frac_shared=cmp["frac_shared"], inter_dict_connections_s=conn_s,
         connections_rows=PAPER["connections_rows"],
         card_vs_cpu=dict(loss_max_rel=loss_rel, cosine_max_abs=cos_err, investigate_max_rel=inv_err,
                          fragments_max_rel=frag_err, matched_sims_max_abs=sims_err),
         launches=launches)


# -- serving (ROADMAP A7a): the harvest sweep's export behind the engine ----------

def serve_rows_pool(torch, cfg, params, lang):
    """Held-out layer-2 residual rows of the subject (f32 on the host) and
    held-out token sequences of the language, for the serving phases."""
    from sparse_coding__tpu_torch.data.activations import capture_fn
    from sparse_coding__tpu_torch.lm import make_tensor_name

    name = make_tensor_name(HARVEST["layer"], "residual")
    heldout = lang.sample(HARVEST["heldout_rows"], HARVEST["seq"], seed=SERVE["rows_seed"])
    rows = capture_fn(cfg, [name], HARVEST["layer"] + 1)(params, torch.from_numpy(heldout).cuda())[name]
    tokens = lang.sample(SERVE["token_rows"], SERVE["seq"], seed=SERVE["tokens_seed"])
    return rows.reshape(-1, cfg.d_model).float().cpu(), tokens


def serve_contract(torch, eng, reg, rows_pool, native=None):
    """The contract at every bucket, dense and top-k 32, on the group of 16
    lanes (the engine not started: this thread is its drainer): the graph
    replay equals the eager dispatch of all lanes and every lane the stack
    of one, bit for bit; top-k values are the dense codes at the indices;
    the served rows agree with the raw `ld.encode` of the unpadded rows
    within rtol 1e-6 / atol 1e-6 (elements that differ are counted). An
    int8 registry (``native`` = the native engine) also stays within the
    bound its quantization allows of the native codes. Returns per-bucket
    counts."""
    from sparse_coding__tpu_torch.serve.engine import encode_lanes

    ids = reg.ids()
    stack = eng._group_stack_for(ids[0])
    check(stack.size == len(ids) == 16, f"one group of 16 lanes, got {stack.size} of {len(ids)}")
    naive = {did: eng._naive_stack(did) for did in ids}
    if stack.weights == "int8":
        for s in naive.values():
            s.dequant()
    raws = [reg.get(did).ld for did in ids]
    g = torch.Generator().manual_seed(SERVE["rows_seed"])
    out = {"differ_unpadded": {}, "max_abs_unpadded": {}, "checked_lanes": 0}
    for b in eng.buckets:
        n = b if b == 8 else b - b // 8
        off = int(torch.randint(0, rows_pool.shape[0] - n, (1,), generator=g))
        rows = rows_pool[off:off + n].contiguous()
        padded = eng._padded_on_device(rows, b)
        dense = None
        for kb in (None, SERVE["topk"]):
            routed, _ = eng._dispatch(stack, rows, b, kb)
            graph = routed.clone() if kb is None else tuple(t.clone() for t in routed)
            eager = encode_lanes(stack.lanes, padded, kb)
            pairs = [(graph, eager)] if kb is None else list(zip(graph, eager))
            check(all(torch.equal(a, e) for a, e in pairs), f"bucket {b} k {kb}: graph replay != eager dispatch")
            for lane, did in enumerate(ids):
                one = encode_lanes(naive[did].lanes, padded, kb)
                same = torch.equal(graph[lane], one[0]) if kb is None else all(
                    torch.equal(a[lane], o[0]) for a, o in zip(graph, one))
                check(same, f"bucket {b} k {kb}: lane {lane} ({did}) != its stack of one")
                out["checked_lanes"] += 1
            if kb is None:
                dense = graph
            else:
                idx, vals = graph
                check(torch.equal(vals, torch.gather(dense, -1, idx.long())), f"bucket {b}: top-k values != codes")
        x = rows.cuda()
        # native: the registry's own dicts; int8: their dequantized stacks of one
        raw = (torch.stack([ld.encode(x) for ld in raws]) if stack.weights == "native"
               else torch.cat([encode_lanes(naive[did].lanes, x) for did in ids]))
        served = dense[:, :n]
        differ = int((served != raw).sum())
        out["differ_unpadded"][b] = differ
        out["max_abs_unpadded"][b] = float((served - raw).abs().max())
        check(torch.allclose(served, raw, rtol=1e-6, atol=1e-6), f"bucket {b}: served rows vs unpadded raw encode")
        if native is not None:
            nstack = native._group_stack_for(ids[0])
            ref = encode_lanes(nstack.lanes, padded, None)[:, :n]
            # |Δc| <= Σ_d |x_d| |ΔW_nd|: half a quantization step a row plus
            # the fp16 product's rounding (relu is 1-Lipschitz)
            w = torch.stack([ld.encoder for ld in raws])
            scale = w.abs().amax(dim=-1, keepdim=True) / 127
            # (|q| <= 127 steps of a scale rounded to fp16, products rounded
            # to fp16), plus the f32 products' own rounding
            step = scale * (0.5 + 127 * 2.0 ** -10) + w.abs() * 2.0 ** -10
            lim = torch.einsum("bd,gnd->gbn", x.abs(), step) + 1e-4 + 1e-5 * ref.abs()
            check(bool(((served - ref).abs() <= lim).all()), f"bucket {b}: int8 codes beyond the quantization bound")
            out.setdefault("int8_max_abs_vs_native", {})[b] = float((served - ref).abs().max())
    return out


def serve_requests(torch, eng, rows_pool, n_requests: int, seed: int):
    """``n_requests`` of random sizes 1..max_batch, half dense, half top-k
    of random k 1..32, from 8 threads; every tenth checked against the stack
    of one at its bucket. Returns the requests served."""
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    ids = eng.registry.ids()
    plan = []
    for i in range(n_requests):
        n = int(rng.integers(1, eng.max_batch + 1))
        off = int(rng.integers(0, rows_pool.shape[0] - n))
        k = None if i % 2 == 0 else int(rng.integers(1, SERVE["topk"] + 1))
        plan.append((ids[int(rng.integers(0, len(ids)))], off, n, k))
    done = [None] * n_requests

    def client(c):
        for i in range(c, n_requests, 8):
            did, off, n, k = plan[i]
            r = eng.submit(did, rows_pool[off:off + n], top_k=k)
            r.result(120)
            done[i] = r

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(0, n_requests, 10):
        did, off, n, k = plan[i]
        got, want = done[i].codes, eng.encode_naive(did, rows_pool[off:off + n], top_k=k, bucket=done[i].bucket)
        same = np.array_equal(got, want) if k is None else all(np.array_equal(a, b) for a, b in zip(got, want))
        check(same, f"request {i} ({did}, {n} rows, k {k}) != its stack of one at bucket {done[i].bucket}")
    return done


def phase_serve_encode(torch, export: Path, rows_pool):
    """The harvest sweep's export (16 TiedSAE, D 512, N 4096) in two
    registries, native and int8-resident, each behind `EncodeEngine
    (max_batch=1024)`: `warmup(topk_ks=(32,))` captures 8 buckets x (dense,
    top-k 32) graphs (int8: and its dequant graph); `serve_contract` at
    every bucket; 200 requests of random sizes and ks capture nothing more;
    replay and eager ms per bucket (CUDA events), the dequant's ms, graph
    count, pool bytes, peak. No hand-written kernel runs: the port's launch
    counts stay 0."""
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
    from sparse_coding__tpu_torch.serve.engine import EncodeEngine, encode_lanes
    from sparse_coding__tpu_torch.serve.registry import DictRegistry

    for mod in (tk, kk, fk):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engines, report = {}, {}
    for weights in ("native", "int8"):
        reg = DictRegistry(device="cuda")
        t0 = time.perf_counter()
        ids = reg.load_export(export, weights=weights)
        load_s = time.perf_counter() - t0
        eng = EncodeEngine(reg, max_batch=SERVE["max_batch"], max_wait_ms=1.0)
        t0 = time.perf_counter()
        n = eng.warmup(topk_ks=(SERVE["topk"],))
        warm_s = time.perf_counter() - t0
        want = 2 * len(eng.buckets) + (weights == "int8")
        check(eng.captures == want and n == 2 * len(eng.buckets), f"{weights}: {eng.captures} captures, want {want}")
        captures = eng.captures
        contract = serve_contract(torch, eng, reg, rows_pool, native=engines.get("native"))
        stack = eng._group_stack_for(ids[0])
        ms = {}
        for b in eng.buckets:
            for kb in (None, SERVE["topk"]):
                gr = stack.graphs[(b, "float32", kb)]
                padded = eng._padded_on_device(rows_pool[:b], b)
                ms[f"b{b}_{'dense' if kb is None else f'k{kb}'}"] = {
                    "replay_ms": time_ms(torch, gr.graph.replay, reps=10),
                    "eager_ms": time_ms(torch, lambda: encode_lanes(stack.lanes, padded, kb), reps=5)}
        dequant_ms = time_ms(torch, stack.graphs[("dequant",)].graph.replay, reps=20) if weights == "int8" else None
        eng.start()
        t0 = time.perf_counter()
        served = serve_requests(torch, eng, rows_pool, SERVE["requests"], seed=SERVE["rows_seed"] + len(engines))
        wall = time.perf_counter() - t0
        check(eng.captures == captures, f"{weights}: {eng.captures - captures} captures after warmup")
        eng.stop()
        engines[weights] = eng
        report[weights] = dict(dicts=len(ids), lanes=stack.size, load_s=load_s, warmup_s=warm_s,
                               capture_s=eng.capture_seconds, graphs=captures, dispatch_ms=ms, dequant_ms=dequant_ms,
                               requests=len(served), requests_wall_s=wall,
                               rows=sum(r.cost_rows for r in served), batches=eng.stats["batches"],
                               batch_occupancy=eng.batch_occupancy, captures_after_warmup=eng.captures - captures,
                               **contract)
    torch.cuda.synchronize()
    pools = graph_pool_bytes(torch)
    peak = torch.cuda.max_memory_allocated() - before
    launches = {**tk.LAUNCHES, **kk.LAUNCHES, **fk.LAUNCHES}
    check(not any(launches.values()), f"serving launched the port's kernels: {launches}")
    G, N_, D_ = 16, HARVEST["ratio"] * 512, 512
    bounds = {b: max(2 * G * b * N_ * D_ / PEAK_F32_FLOPS, (G * N_ * D_ + b * D_ + G * b * N_) * 4 / PEAK_BYTES) * 1e3
              for b in engines["native"].buckets}
    emit("serve_encode", export=str(export.name), max_batch=SERVE["max_batch"], topk=SERVE["topk"],
         buckets=list(engines["native"].buckets), graph_pool_bytes=pools, peak_allocated_bytes=peak,
         kernel_launches=sum(launches.values()), f32_bound_ms=bounds, **report)
    del engines
    torch.cuda.empty_cache()
    return launches


def serve_load(url: str, ids, rows_pool, tokens, seconds: float, check_every: int, seed: int, expected=None,
               stop_after=None, sigterm=None):
    """Closed-loop load from ``SERVE['clients']`` `ServeClient` threads for
    ``seconds`` (or until ``stop_after`` is set): dense /encode of 1..64 rows
    in json, npz and raw, /encode top-k 32 and /features top-k 32 of 1..8
    sequences. Every ``check_every``-th response of a client is recorded
    (or, with ``expected(kind, did, payload, k, bucket)``, checked on the
    spot). A refused connection means the server is gone: once ``sigterm``
    is set the client stops there (retrying a closed ephemeral port can
    connect the client to itself); before, it is a failure. Returns the
    outcomes, latencies and records."""
    import threading
    import urllib.error

    import numpy as np

    from sparse_coding__tpu_torch.serve.server import RetryableRejection, ServeClient

    lock = threading.Lock()
    res = {"ok": 0, "rejected": 0, "conn_error": 0, "bad": [], "lat_ms": [], "rows": 0, "records": [],
           "checked": 0, "by_kind": {}}
    t_end = time.perf_counter() + seconds

    def client(c):
        rng = np.random.default_rng(seed + c)
        cl = ServeClient(url, timeout=60)
        i = 0
        while time.perf_counter() < t_end and not (stop_after is not None and stop_after.is_set()):
            i += 1
            did = ids[int(rng.integers(0, len(ids)))]
            pick = int(rng.integers(0, 5))
            fmt = ("json", "npz", "raw")[pick % 3]
            if pick < 4:
                n = int(rng.integers(1, 65))
                off = int(rng.integers(0, rows_pool.shape[0] - n))
                kind, payload, k = "encode", rows_pool[off:off + n].numpy(), (None if pick < 3 else SERVE["topk"])
            else:
                s = int(rng.integers(1, 9))
                off = int(rng.integers(0, tokens.shape[0] - s))
                kind, payload, k = "features", tokens[off:off + s], SERVE["topk"]
            t0 = time.perf_counter()
            try:
                if kind == "encode":
                    got = cl.encode(did, payload, format=fmt, top_k=k)
                else:
                    got = cl.encode_features(did, tokens=payload, format=fmt, top_k=k)
            except RetryableRejection:
                with lock:
                    res["rejected"] += 1
                continue
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                with lock:
                    if sigterm is not None and sigterm.is_set():
                        res["conn_error"] += 1
                    else:
                        res["bad"].append(f"{kind} {fmt} after {time.perf_counter() - t0:.1f} s: {e!r}"[:300])
                return
            except Exception as e:  # a torn response or any unclean failure
                with lock:
                    res["bad"].append(f"{kind} {fmt}: {e!r}"[:300])
                continue
            lat = (time.perf_counter() - t0) * 1e3
            meta = cl.last_meta
            rows = payload.shape[0] * (payload.shape[1] if kind == "features" else 1)
            rec = (kind, did, payload, k, meta["bucket"], got)
            ok_bits = None
            if expected is not None:
                want = expected(*rec[:5])
                ok_bits = np.array_equal(got, want) if k is None else all(
                    np.array_equal(a, b) for a, b in zip(got, want))
            with lock:
                res["lat_ms"].append(lat)
                res["rows"] += rows
                res["by_kind"][f"{kind}_{fmt}_{'dense' if k is None else 'topk'}"] = res["by_kind"].get(
                    f"{kind}_{fmt}_{'dense' if k is None else 'topk'}", 0) + 1
                if ok_bits is False:
                    res["bad"].append(f"{kind} {fmt} {did} k {k} bucket {meta['bucket']}: wrong bits")
                else:
                    res["ok"] += 1
                res["checked"] += ok_bits is not None
                if expected is None and res["ok"] % check_every == 0:
                    res["records"].append(rec)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res["wall_s"] = time.perf_counter() - t0
    return res


def latency_summary(lat_ms):
    import numpy as np

    if not lat_ms:
        return {}
    a = np.sort(np.asarray(lat_ms))
    return {q: float(a[min(len(a) - 1, int(round(p * (len(a) - 1))))]) for q, p in
            (("p50_ms", 0.5), ("p95_ms", 0.95), ("p99_ms", 0.99))}


def phase_serve_http(torch, export: Path, cfg, params, rows_pool, tokens):
    """`ServeServer` on 127.0.0.1 on the card: the export's 16 dicts and the
    pretrained subject attached at layer 2's residual; `warmup` and
    `warmup_features(128, topk_ks=(32,))`; ``/features`` held to
    `harvest_to_device` then encode for 1, 2, 4 and 8 sequences; then
    `serve_load` for ``SERVE['http_seconds']``, every tenth response held to
    the engine's stack of one at its bucket; no capture after warmup."""
    import numpy as np

    from sparse_coding__tpu_torch.data.activations import harvest_to_device
    from sparse_coding__tpu_torch.serve.registry import DictRegistry
    from sparse_coding__tpu_torch.serve.server import ServeServer
    from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

    reg = DictRegistry(device="cuda")
    ids = reg.load_export(export)
    reg.attach_subject("subject", params, cfg, HARVEST["layer"], "residual", source="subject_pretrain")
    tel = RunTelemetry()
    srv = ServeServer(reg, max_batch=SERVE["max_batch"], max_wait_ms=2.0, telemetry=tel).start()
    try:
        eng = srv.engine
        t0 = time.perf_counter()
        n = eng.warmup(topk_ks=(SERVE["topk"],)) + eng.warmup_features(SERVE["seq"], topk_ks=(SERVE["topk"],))
        warm_s = time.perf_counter() - t0
        warm_graphs = eng.captures
        seqs_cap = eng._seq_cap(SERVE["seq"])
        check(warm_graphs == 2 * (len(eng.buckets) + seqs_cap.bit_length()), f"{warm_graphs} captures after warmup")
        # /features == harvest_to_device then encode, dense and top-k
        features_equal = 0
        for s in (1, 2, 4, 8):
            toks = tokens[:s]
            fused = eng.encode_features(ids[0], toks)
            (chunk,) = harvest_to_device(params, cfg, toks, [HARVEST["layer"]], ["residual"], batch_size=s,
                                         chunk_size_gb=s * SERVE["seq"] * cfg.d_model * 2 / 1024**3, n_chunks=1,
                                         device="cuda")
            two_step = eng.encode(ids[0], chunk[(HARVEST["layer"], "residual")])
            check(np.array_equal(fused, two_step), f"/features of {s} sequences != harvest_to_device then encode")
            idx, vals = eng.encode_features(ids[0], toks, top_k=SERVE["topk"])
            check(np.array_equal(vals, np.take_along_axis(fused, idx.astype(np.int64), axis=1)),
                  f"/features top-k of {s} sequences != its dense codes")
            features_equal += 1
        # the two-step reference's fp16 /encode rows took graphs of their own
        captures = eng.captures
        spans0 = {c: tel.counters.get(f"span.{c}.seconds", 0.0) for c in ("encode", "request_wait", "dequant")}
        batches0, rows0, padded0 = eng.stats["batches"], eng.stats["rows"], eng.stats["padded_rows"]
        res = serve_load(srv.address, ids, rows_pool, tokens, SERVE["http_seconds"], check_every=10, seed=101)
        check(res["bad"] == [] and res["rejected"] == 0 and res["conn_error"] == 0, f"serve_http outcomes {res['bad'][:5]}")
        for kind, did, payload, k, bucket, got in res["records"]:
            if kind == "encode":
                want = eng.encode_naive(did, payload, top_k=k, bucket=bucket)
            else:
                want = eng.features_naive(did, payload, top_k=k, seq_bucket=bucket // SERVE["seq"])
            same = np.array_equal(got, want) if k is None else all(np.array_equal(a, b) for a, b in zip(got, want))
            check(same, f"served {kind} {did} k {k} at bucket {bucket} != the stack of one")
        check(eng.captures == captures, f"{eng.captures - captures} captures under load")
        spans = {c: tel.counters.get(f"span.{c}.seconds", 0.0) - spans0[c] for c in spans0}
        batches = eng.stats["batches"] - batches0
        rows = eng.stats["rows"] - rows0
        occupancy = rows / max(1, rows + eng.stats["padded_rows"] - padded0)
        emit("serve_http", dicts=len(ids), subject=f"{SUBJECT['model']} layer {HARVEST['layer']} residual (pretrained)",
             clients=SERVE["clients"], seconds=res["wall_s"], warmup_dispatches=n, warmup_s=warm_s, graphs=warm_graphs,
             fp16_reference_graphs=captures - warm_graphs,
             capture_s=eng.capture_seconds, features_bit_equal_harvest=features_equal,
             requests=res["ok"], requests_per_s=res["ok"] / res["wall_s"], rows_per_s=res["rows"] / res["wall_s"],
             **latency_summary(res["lat_ms"]), checked_bit_equal=len(res["records"]), mix=res["by_kind"],
             span_seconds=spans, batches=batches, batch_occupancy=occupancy, captures_under_load=eng.captures - captures,
             wire=srv.wire_stats)
    finally:
        srv.stop()
        tel.close()
    torch.cuda.empty_cache()


def serve_worker(argv) -> int:
    """``chip_smoke.py --serve-worker <export> <port_file> <events_dir>``: the
    port's server (`serve.server.main`) as a process of its own on the card,
    with `SERVE['subject_spec']` attached for /features."""
    from sparse_coding__tpu_torch.serve.server import main as serve_main

    return serve_main([argv[0], "--port", "0", "--port-file", argv[1], "--events", argv[2], "--max-batch",
                       str(SERVE["max_batch"]), "--max-wait-ms", "2", "--warmup-topk", str(SERVE["topk"]),
                       "--subject", SERVE["subject_spec"], "--subject-seq-len", str(SERVE["seq"])])


def phase_serve_drain(torch, root: Path, export: Path, rows_pool, tokens):
    """`serve_worker` under `serve_load`, SIGTERMed mid-load: it must exit 0
    after "drained clean", every response bit-equal to this process's
    stack of one at its bucket (the same export, the same seeded random
    subject), every other outcome a retryable 503 or a refused connection
    after the listener closed: none dropped."""
    import signal
    import threading

    import numpy as np

    from sparse_coding__tpu_torch.serve.engine import EncodeEngine
    from sparse_coding__tpu_torch.serve.registry import DictRegistry
    from sparse_coding__tpu_torch.serve.server import attach_subject_from_spec

    reg = DictRegistry(device="cuda")
    ids = reg.load_export(export)
    attach_subject_from_spec(reg, SERVE["subject_spec"])
    ref = EncodeEngine(reg, max_batch=SERVE["max_batch"])
    cache, lock = {}, threading.Lock()

    def expected(kind, did, payload, k, bucket):
        key = (kind, did, payload.tobytes(), payload.shape, k, bucket)
        with lock:
            if key not in cache:
                cache[key] = (ref.encode_naive(did, payload, top_k=k, bucket=bucket) if kind == "encode" else
                              ref.features_naive(did, payload, top_k=k, seq_bucket=bucket // SERVE["seq"]))
            return cache[key]

    port_file, events = root / "serve_port", root / "serve_events"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    t_start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--serve-worker", str(export), str(port_file),
                             str(events)], env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while not port_file.exists() and time.time() < deadline:
            if proc.poll() is not None:
                check(False, f"serve worker died early: {proc.stdout.read()[-3000:]}")
            time.sleep(0.2)
        check(port_file.exists(), "serve worker never bound a port")
        ready_s = time.perf_counter() - t_start
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        stop, sigterm = threading.Event(), threading.Event()
        box = {}
        loader = threading.Thread(target=lambda: box.update(res=serve_load(
            url, ids, rows_pool, tokens, 600.0, check_every=1, seed=202, expected=expected, stop_after=stop,
            sigterm=sigterm)))
        t_load = time.perf_counter()
        loader.start()
        time.sleep(SERVE["drain_seconds"])
        sigterm.set()
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        exited = threading.Thread(target=lambda: box.update(rc=proc.wait(), exit_s=time.perf_counter() - t_term))
        exited.start()
        time.sleep(1.0)  # the clients keep sending through the drain
        stop.set()
        loader.join(120)
        exited.join(120)
        rc = box.get("rc")
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = box["res"]
    check(rc == 0 and "drained clean" in out, f"serve worker exit {rc}: {out[-3000:]}")
    check(res["bad"] == [], f"serve_drain bad outcomes {res['bad'][:5]}")
    check(res["ok"] > 0 and res["checked"] == res["ok"], f"serve_drain outcomes {res['ok']} ok, {res['checked']} checked")
    drained = [json.loads(line) for line in (events / "events.jsonl").read_text().splitlines()
               if '"serve_drained"' in line]
    check(len(drained) == 1, "no serve_drained event")
    emit("serve_drain", worker_ready_s=ready_s, requests_ok_bit_equal=res["ok"], rejected_503=res["rejected"],
         refused_after_close=res["conn_error"], dropped=len(res["bad"]), exit=rc, exit_s=box.get("exit_s"),
         drain_s=drained[0].get("drain_s"), worker_tail=out.strip().splitlines()[-1],
         served_by_worker=drained[0].get("requests"), requests_per_s_before_sigterm=res["ok"] / (t_term - t_load),
         **latency_summary(res["lat_ms"]), mix=res["by_kind"], subject=SERVE["subject_spec"])


# -- the replicated tier (ROADMAP A7b): the replicaset CLI on the card ------------

def rolled_export(torch, src: Path, dst: Path) -> Path:
    """Generation 1 of an export: the same ids, each TiedSAE's rows (encoder
    and bias) rolled by one feature, so every code moves to the next index."""
    from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    out = []
    for ld, hp in load_learned_dicts(src, verify=True, device="cpu"):
        check(type(ld) is TiedSAE, f"{type(ld).__name__}: the tier phase rolls TiedSAE rows")
        out.append((TiedSAE(torch.roll(ld.encoder, 1, 0), torch.roll(ld.encoder_bias, 1, 0),
                            (ld.center_trans, ld.center_rot, ld.center_scale), ld.norm_encoder), hp))
    dst.mkdir(parents=True, exist_ok=True)
    save_learned_dicts(dst / src.name, out)
    return dst / src.name


def read_jsonl(path: Path):
    """The records of an events file another process is writing (a torn
    last line is skipped)."""
    out = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return out


def compute_apps():
    """``nvidia-smi --query-compute-apps``: {pid: used MiB}, pids as the
    driver sees them (another pid namespace than this process's may show
    other numbers, or none)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    apps = {}
    for line in res.stdout.strip().splitlines():
        pid, _, mib = (x.strip() for x in line.partition(","))
        if pid.isdigit():
            apps[int(pid)] = float(mib) if mib.replace(".", "", 1).isdigit() else mib
    return apps


def card_used_mib() -> float:
    """``nvidia-smi --query-gpu=memory.used``: MiB in use on the card, by
    every process."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.split()[0])


def tier_load(url: str, ids, rows_pool, expected, stop, seed: int):
    """Closed-loop load from ``SERVE_TIER['clients']`` `RouterClient` threads
    until ``stop`` is set: json /encode of 1..64 rows, dense or top-k 32.
    Every 200 is held on the spot to ``expected(generation, did, off, n, k,
    bucket)``; a router shed or a retryable 503 is counted (and backed off
    50 ms), anything else is a failure. Returns the outcomes (with a record a
    response: wall time done, ms, rows, generation, replica, attempts) and
    the started threads."""
    import threading

    import numpy as np

    from sparse_coding__tpu_torch.serve.router import RouterClient, ShedRejection
    from sparse_coding__tpu_torch.serve.server import RetryableRejection

    lock = threading.Lock()
    res = {"ok": 0, "shed": 0, "rejected": 0, "bad": [], "records": [], "retried_ok": 0, "topk": 0}

    def client(c):
        rng = np.random.default_rng(seed + c)
        cl = RouterClient(url, timeout=60)
        while not stop.is_set():
            did = ids[int(rng.integers(0, len(ids)))]
            n = int(rng.integers(1, SERVE_TIER["max_rows"] + 1))
            off = int(rng.integers(0, rows_pool.shape[0] - n))
            k = SERVE_TIER["topk"] if rng.integers(0, 2) else None
            t0 = time.perf_counter()
            try:
                got, meta = cl.encode_with_meta(did, rows_pool[off:off + n].numpy(), top_k=k)
            except ShedRejection:
                with lock:
                    res["shed"] += 1
                time.sleep(0.05)
                continue
            except RetryableRejection:
                with lock:
                    res["rejected"] += 1
                time.sleep(0.05)
                continue
            except Exception as e:  # a dropped request, a torn response, any unclean failure
                with lock:
                    res["bad"].append(f"{did} {n} rows k {k}: {e!r}"[:300])
                continue
            ms, done = (time.perf_counter() - t0) * 1e3, time.time()
            gen, bucket = meta["generation"], cl.last_meta["bucket"]
            want = expected(gen, did, off, n, k, bucket)
            same = want is not None and (np.array_equal(got, want) if k is None else
                                         all(np.array_equal(a, b) for a, b in zip(got, want)))
            with lock:
                if not same:
                    res["bad"].append(f"{did} {n} rows k {k} gen {gen} bucket {bucket}: wrong or torn bits")
                    continue
                res["ok"] += 1
                res["topk"] += k is not None
                res["retried_ok"] += meta["attempts"] > 1
                res["records"].append((done, ms, n, gen, meta["replica"], meta["attempts"]))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_TIER["clients"])]
    for t in threads:
        t.start()
    return res, threads


def window(records, t0: float, t1: float):
    """Requests/s, rows/s and latency over the responses done in [t0, t1)."""
    sel = [r for r in records if t0 <= r[0] < t1]
    span = max(1e-9, t1 - t0)
    return {"seconds": t1 - t0, "requests": len(sel), "requests_per_s": len(sel) / span,
            "rows_per_s": sum(r[2] for r in sel) / span, "retried": sum(r[5] > 1 for r in sel),
            **latency_summary([r[1] for r in sel])}


def phase_serve_tier(torch, root: Path, export: Path, rows_pool):
    """The replicated tier on the card: ``python -m
    sparse_coding__tpu_torch.serve.replicaset`` as a process of its own (2
    replicas at max_batch 256, each its own process and CUDA context, the
    router, ``--swap-file``, ``--metrics-port``) under `tier_load`; one
    replica SIGKILLed mid-load, then generation 1 (`rolled_export`) rolled
    out through the swap file, then the tier SIGTERMed. Every response must
    be bit-equal to this process's stack of one for its declared generation
    at its bucket, every other outcome a retryable 503 (none dropped), both
    replicas' ``run_start`` on cuda, the killed one marked dead and
    readmitted, generation 0 before the swap and 1 after it, exit 0. Prints
    the load by window, 1 vs 2 replicas and the router's added latency
    (`serve.loadgen.run_load` through in-process routers and straight to a
    replica), the kill timeline, the swap walls, memory and captures a
    replica, and the router's retries, hedges and sheds."""
    import re
    import signal
    import threading
    import urllib.request

    import numpy as np

    from sparse_coding__tpu_torch.serve.engine import EncodeEngine
    from sparse_coding__tpu_torch.serve.loadgen import run_load
    from sparse_coding__tpu_torch.serve.registry import DictRegistry
    from sparse_coding__tpu_torch.serve.router import Router
    from sparse_coding__tpu_torch.serve.server import ServeClient
    from sparse_coding__tpu_torch.telemetry.metrics_http import family_value, scrape

    t_phase = time.perf_counter()
    tier = root / "serve_tier"
    exports = [export, rolled_export(torch, export, tier / "gen1")]
    refs = []
    for exp in exports:
        reg = DictRegistry(device="cuda")
        ids = reg.load_export(exp)
        refs.append(EncodeEngine(reg, max_batch=256))
    cache, ref_lock = {}, threading.Lock()

    def expected(gen, did, off, n, k, bucket):
        if gen not in (0, 1):
            return None
        key = (gen, did, off, n, k, bucket)
        with ref_lock:
            if key not in cache:
                cache[key] = refs[gen].encode_naive(did, rows_pool[off:off + n], top_k=k, bucket=bucket)
            return cache[key]

    run_dir, port_file, swap_file, log_path = tier / "run", tier / "router_port", tier / "swap", tier / "tier.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    env["PYTHONPATH"] = str(REPO)
    cmd = [sys.executable, "-m", "sparse_coding__tpu_torch.serve.replicaset", str(export), "--replicas",
           str(SERVE_TIER["replicas"]), "--run-dir", str(run_dir), "--port", "0", "--port-file", str(port_file),
           "--swap-file", str(swap_file), "--metrics-port", "0", "--warmup-topk", str(SERVE_TIER["topk"])]
    used_before = card_used_mib()
    with open(log_path, "w") as log:
        t_spawn = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    rs_events, router_events = run_dir / "replicaset_events.jsonl", run_dir / "router_events.jsonl"
    stop = threading.Event()
    threads = []

    def wait_for(cond, timeout: float, what: str):
        deadline = time.time() + timeout
        while time.time() < deadline:
            got = cond()
            if got:
                return got
            check(proc.poll() is None, f"the tier exited {proc.returncode} waiting for {what}: "
                                       f"{log_path.read_text()[-3000:]}")
            time.sleep(0.1)
        check(False, f"timed out after {timeout} s waiting for {what}")

    def spawned_pids():
        return {e["replica"]: e["pid"] for e in read_jsonl(rs_events) if e["event"] == "replica_spawn"}

    def replica_urls():
        return {f"replica{i}": f"http://127.0.0.1:{(run_dir / f'replica{i}' / 'port').read_text().strip()}"
                for i in range(SERVE_TIER["replicas"])}

    def healthz(url):
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.loads(r.read())

    try:
        wait_for(port_file.exists, SERVE_TIER["ready_timeout_s"], "the router's port file")
        ready_s = time.perf_counter() - t_spawn
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        metrics_url = wait_for(lambda: re.search(r"/metrics on (http://\S+)/metrics", log_path.read_text()), 30,
                               "the replicaset's metrics address").group(1)
        pids0, urls0 = spawned_pids(), replica_urls()
        captures0 = {rid: healthz(u)["captures"] for rid, u in urls0.items()}
        memory0, used_ready = compute_apps(), card_used_mib()

        # -- before the kill ---------------------------------------------------------
        res, threads = tier_load(url, ids, rows_pool, expected, stop, SERVE_TIER["seed"])
        t_load = time.time()
        time.sleep(SERVE_TIER["before_s"])

        # -- SIGKILL replica1 mid-load, by its replica_spawn pid ---------------------
        victim = pids0["replica1"]
        used_kill = card_used_mib()
        t_kill = time.time()
        os.kill(victim, signal.SIGKILL)
        samples, readmitted = [], threading.Event()

        def sample_card():  # the card's memory in use, from the kill to the readmission
            while not readmitted.is_set() and time.time() < t_kill + SERVE_TIER["readmit_timeout_s"]:
                samples.append((time.time() - t_kill, card_used_mib()))
                time.sleep(0.1)

        sampler = threading.Thread(target=sample_card)
        sampler.start()

        def after_kill(events, pred):
            return next((e for e in read_jsonl(events) if e.get("ts", 0) >= t_kill and pred(e)), None)

        readmit = wait_for(lambda: after_kill(router_events, lambda e: e["event"] == "router_replica_state" and
                                              e["replica"] == "replica1" and e["to"] == "live"),
                           SERVE_TIER["readmit_timeout_s"], "the killed replica's readmission")
        t_readmit = readmit["ts"]
        readmitted.set()
        dead = after_kill(router_events, lambda e: e["event"] == "router_replica_state" and e["replica"] == "replica1"
                          and e["to"] == "dead")
        exited = after_kill(rs_events, lambda e: e["event"] == "replica_exit" and e["replica"] == "replica1")
        respawn = after_kill(rs_events, lambda e: e["event"] == "replica_spawn" and e["replica"] == "replica1")
        ready = after_kill(rs_events, lambda e: e["event"] == "replica_ready" and e["replica"] == "replica1")
        sampler.join(60)
        check(dead is not None, "the router never marked the killed replica dead")
        check(exited is not None and exited["classification"] == "killed", f"replica exit record {exited}")
        check(respawn is not None and respawn["pid"] != victim and ready is not None, "no relaunch recorded")
        port_mtime = (run_dir / "replica1" / "port").stat().st_mtime
        timeline = {"dead_s": dead["ts"] - t_kill, "exit_classified_s": exited["ts"] - t_kill,
                    "spawn_s": respawn["ts"] - t_kill, "port_file_s": port_mtime - t_kill,
                    "ready_s": ready["ts"] - t_kill, "readmit_s": t_readmit - t_kill,
                    "downtime_seconds": ready.get("downtime_seconds"), "dead_reason": dead["reason"],
                    "card_used_mib_at_kill": used_kill,
                    "card_used_mib_low_before_spawn": min((u for t, u in samples if t < respawn["ts"] - t_kill),
                                                          default=None),
                    "card_used_mib_at_readmit": samples[-1][1] if samples else None}
        # the victim's memory is back before its successor starts when the
        # card's use falls by most of a replica's share before the spawn
        replica_mib = (used_ready - used_before) / SERVE_TIER["replicas"]
        timeline["victim_memory_released_before_successor_spawn"] = (
            None if timeline["card_used_mib_low_before_spawn"] is None else
            used_kill - timeline["card_used_mib_low_before_spawn"] >= 0.5 * replica_mib)

        # -- roll out generation 1 through the swap file -----------------------------
        time.sleep(1.0)
        tmp = swap_file.with_name(swap_file.name + ".tmp")
        tmp.write_text(str(exports[1]) + "\n")
        t_swap = time.time()
        tmp.rename(swap_file)
        done = wait_for(lambda: next((e for e in read_jsonl(rs_events) if e["event"] == "rolling_swap_done"), None),
                        SERVE_TIER["swap_timeout_s"], "the rolling swap")
        t_swapped = done["ts"]
        check(done["generation"] == 1 and done["replicas"] == SERVE_TIER["replicas"], f"rolling swap {done}")
        time.sleep(SERVE_TIER["after_s"])
        t_end = time.time()
        stop.set()
        for t in threads:
            t.join(120)
        check(not any(t.is_alive() for t in threads), "a tier client never returned")
        records = res["records"]

        # -- 1 vs 2 replicas, and the router's added latency, same load --------------
        urls = replica_urls()
        captures1 = {rid: healthz(u)["captures"] for rid, u in urls.items()}
        memory1 = compute_apps()
        rng = np.random.default_rng(SERVE_TIER["seed"] + 99)

        def payload(r):
            n = int(r.integers(1, SERVE_TIER["max_rows"] + 1))
            off = int(r.integers(0, rows_pool.shape[0] - n))
            return rows_pool[off:off + n].numpy(), (SERVE_TIER["topk"] if r.integers(0, 2) else None)

        def measured(client):
            out = run_load(lambda did, p: client.encode(did, p[0], top_k=p[1]), ids,
                           n_clients=SERVE_TIER["clients"], requests_per_client=SERVE_TIER["compare_requests"],
                           seed=int(rng.integers(0, 2**31)), payload_fn=payload, rows_of=lambda p: p[0].shape[0])
            check(out["errors"] == 0 and out["shed"] == 0 and out["rejected"] == 0, f"comparison load {out}")
            return {k: out[k] for k in ("requests_per_sec", "rows_per_sec", "p50_ms", "p95_ms", "p99_ms")}

        routers = {"router_1_replica": Router({"replica0": urls["replica0"]}).start(),
                   "router_2_replicas": Router(urls).start()}
        compare = {k: [] for k in ("direct_replica0", "router_1_replica", "router_2_replicas")}
        try:
            for name in ("direct_replica0", "router_1_replica", "router_2_replicas", "router_2_replicas",
                         "router_1_replica", "direct_replica0"):
                client = ServeClient(urls["replica0"]) if name == "direct_replica0" else routers[name].client()
                compare[name].append(measured(client))
        finally:
            for r in routers.values():
                r.stop()

        def mean(name, key):
            return sum(t[key] for t in compare[name]) / len(compare[name])

        fams = scrape(url)
        router_counts = {k: family_value(fams, f"router.{k}", "_total", 0.0) for k in
                         ("requests", "ok", "retried_ok", "retries", "hedges", "sheds", "failed", "forwards")}
        supervisor = {k: family_value(scrape(metrics_url), f"replicaset.{k}", "_total", 0.0) for k in
                      ("deaths", "deaths.killed", "restarts", "swaps")}

        # -- SIGTERM the tier ---------------------------------------------------------
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
        exit_s = time.perf_counter() - t_term
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                pass
        try:  # the replicas share the tier's process group: none outlives the phase
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    out = log_path.read_text()
    check(rc == 0 and "drain requested" in out, f"the tier exited {rc}: {out[-3000:]}")
    check(res["bad"] == [], f"serve_tier bad outcomes ({len(res['bad'])}): {res['bad'][:5]}")
    gens_before = {r[3] for r in records if r[0] < t_swap}
    gens_after = {r[3] for r in records if r[0] >= t_swapped}
    check(gens_before == {0} and gens_after == {1}, f"generations before the swap {gens_before}, after {gens_after}")
    devices = {}
    for i in range(SERVE_TIER["replicas"]):
        starts = [e for e in read_jsonl(run_dir / f"replica{i}" / "events.jsonl") if e["event"] == "run_start"]
        devices[f"replica{i}"] = [e["config"]["device"] for e in starts]
        check(starts and all(d == "cuda" for d in devices[f"replica{i}"]), f"replica{i} run_start devices {devices}")
    rs_recs, r_recs = read_jsonl(rs_events), read_jsonl(router_events)
    swap_walls = {}
    for rid in urls:
        q = next(e["ts"] for e in r_recs if e["event"] == "router_replica_quiesced" and e["replica"] == rid
                 and e["ts"] >= t_swap)
        a = next(e["ts"] for e in r_recs if e["event"] == "router_replica_readmitted" and e["replica"] == rid
                 and e["ts"] >= q)
        drained = next(e for e in rs_recs if e["event"] == "replica_drained" and e["replica"] == rid and e["ts"] >= q)
        swap_walls[rid] = {"quiesce_to_readmit_s": a - q, "drain_s": drained["seconds"],
                           "drain_exit_code": drained["exit_code"]}
        check(drained["exit_code"] == 0, f"{rid} drained with exit {drained['exit_code']}")

    def by_replica(pids, memory):
        return {rid: {"pid": pid, "used_mib": memory.get(pid, "not listed")} for rid, pid in pids.items()}

    emit("serve_tier", replicas=SERVE_TIER["replicas"], clients=SERVE_TIER["clients"], max_batch=256,
         tier_ready_s=ready_s, requests_ok_bit_equal=res["ok"], topk_ok=res["topk"], retried_ok=res["retried_ok"],
         shed_503=res["shed"], retryable_503=res["rejected"], dropped=len(res["bad"]), exit=rc, exit_s=exit_s,
         windows={"before_kill": window(records, t_load, t_kill), "across_restart": window(records, t_kill, t_readmit),
                  "across_swap": window(records, t_swap, t_swapped), "after_swap": window(records, t_swapped, t_end)},
         compare={name: {"requests_per_s": mean(name, "requests_per_sec"), "rows_per_s": mean(name, "rows_per_sec"),
                         "p50_ms": mean(name, "p50_ms"), "p99_ms": mean(name, "p99_ms"), "turns": compare[name]}
                  for name in compare},
         router_added_p50_ms=mean("router_1_replica", "p50_ms") - mean("direct_replica0", "p50_ms"),
         two_over_one_replica_requests=mean("router_2_replicas", "requests_per_sec") /
         mean("router_1_replica", "requests_per_sec"),
         kill_timeline=timeline, swap_walls=swap_walls, swap_s=t_swapped - t_swap, run_start_devices=devices,
         card_used_mib={"before_tier": used_before, "tier_ready": used_ready, "per_replica": replica_mib},
         memory_at_start=by_replica(pids0, memory0), memory_after_swap=by_replica(spawned_pids(), memory1),
         compute_apps_listed={"at_start": memory0, "after_swap": memory1},
         captures_at_start=captures0, captures_after_swap=captures1, router=router_counts,
         replicaset=supervisor, seconds=time.perf_counter() - t_phase)


# -- scale-out (ROADMAP A6b's first part) at BASELINE config 5's widths ----------
# the Pythia-410M residual (D 1024), a 32x dictionary (N 32768), 4 tied
# members (l1 1e-4..3e-3, as scripts/dictpar_run.py), batch 2048, bf16
# compute, Adam lr 1e-3 with f32 moments; planted data from the seed. A world
# of one over NCCL in this process, then a world of two processes on the one
# card over gloo (NCCL refuses two ranks on one device), each rank its own
# CUDA context, the collectives' bytes through host memory. FISTA's sharded
# step at config 3's widths (D 512, N 2048, 4 members, batch 2048, 500
# iterations). The sweep: 2 chunks of 4,096 rows of config 5's width.
SCALE = dict(width=1024, n_dict=32768, l1=[1e-4, 3e-4, 1e-3, 3e-3], batch=2048, steps=3, seed=71,
             n_ground_truth=4096, nonzero=32, decay=0.996, sweep_rows=4096, timeout=240)
SCALE_FISTA = dict(width=512, n_dict=2048, batch=2048, iters=500, seed=73)


def scale_build(pkg, mesh=None, shard_dict=True, key=0):
    ens = pkg.build_ensemble(pkg.FunctionalTiedSAE, key, [{"l1_alpha": a} for a in SCALE["l1"]],
                             optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16",
                             activation_size=SCALE["width"], n_dict_components=SCALE["n_dict"])
    return ens if mesh is None else ens.shard(mesh, shard_dict)


def scale_batches(torch):
    """The planted batches [steps, B, D], drawn on the card from the seed
    (every rank draws the same)."""
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    gen = RandomDatasetGenerator(SCALE["width"], SCALE["n_ground_truth"], SCALE["batch"], SCALE["nonzero"],
                                 SCALE["decay"], False, key=SCALE["seed"])
    return torch.stack([next(gen) for _ in range(SCALE["steps"])])


def member_digests(torch, ens, first: int = 0):
    """A digest of each held member's bits (params and moments), by global
    member index: two int64 sums over the int32 views (plain and weighted by
    position), computed on the card."""
    st = ens.state
    leaves = [st.params["encoder"], st.params["encoder_bias"], st.opt_state.mu["encoder"], st.opt_state.nu["encoder"],
              st.opt_state.mu["encoder_bias"], st.opt_state.nu["encoder_bias"]]
    out = {}
    for i in range(leaves[0].shape[0]):
        parts = []
        for t in leaves:
            v = t[i].contiguous().view(torch.int32).flatten().to(torch.int64)
            w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1
            parts += [int(v.sum()), int((v * w).sum())]
        out[first + i] = parts
    return out


def timed_steps(torch, ens, batches, mesh=None):
    """Eager steps, counted and timed: (losses [K, M], launches by kernel,
    device ms a step, wall ms a step, the collectives' ms and bytes a step,
    the peak device memory)."""
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats0 = dict(mesh.stats) if mesh is not None else None
    tk.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = torch.stack([ens.step_batch(b)[0]["loss"] for b in batches])
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    k = len(batches)
    out = dict(losses=losses, launches=dict(tk.LAUNCHES), ms=start.elapsed_time(end) / k, wall_ms=wall * 1e3 / k,
               peak_bytes=torch.cuda.max_memory_allocated())
    if mesh is not None:
        out["collective_ms"] = (mesh.stats["seconds"] - stats0["seconds"]) * 1e3 / k
        out["collective_bytes"] = (mesh.stats["bytes"] - stats0["bytes"]) / k
        out["collective_calls"] = (mesh.stats["calls"] - stats0["calls"]) / k
    return out


def scale_k3_row(torch, tk, g, shape):
    """K3 at ``shape`` = (M, B, N, D) on K1's output, against its plain
    version (cosine > 0.9999, max error < 1e-2 of the max), timed beside the
    plain version, the bound and the `bmm` calls."""
    dev = torch.device("cuda")
    M, B, N, D = shape
    label = f"M={M},B={B},N={N},D={D}"
    d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    bias = torch.randn((M, N), generator=g, device=dev) * 0.01
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    l1b = torch.logspace(-4, -2, M, device=dev) / B
    gk, gbk = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    gp, gbp = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    torch.cuda.synchronize()
    cos, rel = grads_close(torch, gk, gp, f"K3 at {label} g_enc")
    grads_close(torch, gbk, gbp, f"K3 at {label} g_bias")
    nnz = int((c != 0).sum())
    ct, xbt, dbt = c.transpose(1, 2), xb.expand(M, B, D), db.transpose(1, 2)
    row = dict(name="tied_sae_bwd_grads", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd.cu",
               replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:201", shape=label,
               max_abs_err=float((gk - gp).abs().max()),
               variant="gradient out" + ("" if D <= 512 else ", WMMA bwd_kernel"),
               ms=time_ms(torch, lambda: tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b), 10),
               plain_ms=time_ms(torch, lambda: tk._grads_plain(xb, dxh, c, nrm, db, l1b), 3),
               library_ms=time_ms(torch, lambda: (torch.bmm(dxh, dbt), torch.bmm(ct, dxh), torch.bmm(ct, xbt)), 10))
    row["bound_ms"], row["bound_by"] = bound(
        6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4 + M * N * D * 2 + M * N * D * 4 + M * N * 4 + M * 4)
    emit("kernel", name="tied_sae_bwd_grads", shape=label, cos=cos, max_rel=rel, ms=row["ms"],
         bound_ms=row["bound_ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"])
    return row


def scale_store(torch, root: Path) -> Path:
    """The sweep's store: 2 fp16 chunks of config 5's width, planted."""
    import numpy as np

    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    gen = RandomDatasetGenerator(SCALE["width"], SCALE["n_ground_truth"], 4096, SCALE["nonzero"], SCALE["decay"],
                                 False, key=SCALE["seed"] + 1)
    folder = root / "act"
    generate_synthetic_chunks(gen, folder, 2, chunk_size_gb=SCALE["sweep_rows"] * SCALE["width"] * 2 / 1024**3,
                              dtype=np.dtype("float16"))
    return folder


def scale_sweep_cfg(root: Path, out: str):
    from sparse_coding__tpu_torch.utils.config import SyntheticEnsembleArgs

    return SyntheticEnsembleArgs(use_synthetic_dataset=True, activation_width=SCALE["width"], n_chunks=2,
                                 chunk_size_gb=SCALE["sweep_rows"] * SCALE["width"] * 2 / 1024**3, n_epochs=1,
                                 batch_size=SCALE["batch"], dataset_folder=str(root / "act"),
                                 output_folder=str(root / out), seed=0)


def scale_sweep_init(mesh_shape):
    """The sweep's one ensemble (config 5's 4 members), sharded on the mesh
    of ``mesh_shape`` (None: unsharded)."""

    def init(cfg):
        import sparse_coding__tpu_torch as pkg
        from sparse_coding__tpu_torch.parallel import make_mesh

        ens = scale_build(pkg, None if mesh_shape is None else make_mesh(*mesh_shape))
        return ([(ens, {"batch_size": cfg.batch_size, "dict_size": SCALE["n_dict"]}, "dictpar")], ["dict_size"],
                ["l1_alpha"], {"l1_alpha": SCALE["l1"], "dict_size": [SCALE["n_dict"]]})

    return init


def scaleout_worker(argv) -> int:
    """``chip_smoke.py --scaleout-worker <rank> <world> <root>``: one rank of
    the world of two on the one card (gloo through a file store in
    ``root``). Runs the cases in turn, each result written to
    ``root/r<rank>.json`` as it finishes; the preempted sweep last (exit 75)."""
    import warnings

    import torch

    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.parallel import initialize_distributed, make_mesh
    from sparse_coding__tpu_torch.parallel.mesh import DICT_AXIS
    from sparse_coding__tpu_torch.train.preemption import Preempted
    from sparse_coding__tpu_torch.train.sweep import sweep

    warnings.simplefilter("ignore", UserWarning)  # the data axis' fused-Adam refusal, reported in the results
    rank, world, root = int(argv[0]), int(argv[1]), Path(argv[2])
    t_init = time.perf_counter()
    check(initialize_distributed(f"file://{root / 'store2'}", world, rank), "world of two did not start")
    check(torch.distributed.get_backend() == "gloo" and torch.cuda.current_device() == 0, "backend / device")
    refs = json.loads((root / "world1.json").read_text())
    res = {"init_s": time.perf_counter() - t_init}
    out = root / f"r{rank}.json"

    def save():
        out.write_text(json.dumps(res))

    batches = scale_batches(torch)

    # (2,1,1): each rank two members, their bits the world of one's
    mesh = make_mesh(2, 1, 1)
    ens = scale_build(pkg, mesh)
    run = timed_steps(torch, ens, batches, mesh)
    digests = member_digests(torch, ens, first=2 * mesh.coords["model"])
    want = {int(k): v for k, v in refs["digests"].items()}
    check(all(digests[i] == want[i] for i in digests), f"rank {rank}: (2,1,1) members differ from the world of one")
    # the losses are sums of K1's per-block partials, whose reduction order
    # torch picks by the tensor's shape (2 members here, 4 there): not bits
    ref_losses = torch.tensor(refs["losses"])
    loss_rel = float(((run["losses"].cpu() - ref_losses).abs() / ref_losses.abs()).max())
    check(loss_rel < 1e-6, f"rank {rank}: (2,1,1) losses off the world of one's by {loss_rel}")
    check(run["launches"]["tied_sae_fwd"] > 0 and run["launches"]["tied_sae_bwd_adam"] > 0,
          f"(2,1,1) {run['launches']}")
    res["model_211"] = dict({k: v for k, v in run.items() if k != "losses"}, members=sorted(digests), bit_equal=True,
                            loss_max_rel=loss_rel)
    del ens
    torch.cuda.empty_cache()
    save()

    # (1,2,1): K1 + K3 on the local rows, one all-reduce, the port's Adam;
    # the first step's summed gradient against the full batch's on the same
    # route (K3's pins), the losses against the world of one's on that route
    mesh = make_mesh(1, 2, 1)
    ens = scale_build(pkg, mesh)
    check(ens.fused_adam is None and ens._route(SCALE["batch"] // 2, False, False) == "fused_grads",
          f"(1,2,1) route {ens._route(SCALE['batch'] // 2, False, False)}")
    full = scale_build(pkg)
    st, fst = ens.state, full.state
    with torch.no_grad():
        g_sh, _ = ens._data_mean(*ens.sig.fused_grads_stacked(st.params, st.buffers, ens.local_batch(batches[0])))
        g_ref, _ = full.sig.fused_grads_stacked(fst.params, fst.buffers, batches[0])
    cos, rel = grads_close(torch, g_sh["encoder"], g_ref["encoder"], "(1,2,1) summed g_enc")
    cos_b, rel_b = grads_close(torch, g_sh["encoder_bias"], g_ref["encoder_bias"], "(1,2,1) summed g_bias")
    del full, g_sh, g_ref
    torch.cuda.empty_cache()
    run = timed_steps(torch, ens, batches, mesh)
    lrel = float(((run["losses"].cpu() - torch.tensor(refs["losses_grads"])).abs()
                  / torch.tensor(refs["losses_grads"]).abs()).max())
    check(lrel < 1e-3, f"(1,2,1) losses off the full batch's by {lrel}")
    check(run["launches"]["tied_sae_fwd"] > 0 and run["launches"]["tied_sae_bwd_grads"] > 0
          and run["launches"]["tied_sae_bwd_adam"] == 0, f"(1,2,1) {run['launches']}")
    res["data_121"] = dict({k: v for k, v in run.items() if k != "losses"}, grad_cos=cos, grad_max_rel=rel,
                           bias_grad_cos=cos_b, bias_grad_max_rel=rel_b, loss_max_rel=lrel)
    del ens
    torch.cuda.empty_cache()
    save()

    # (1,1,2): autograd on the local half of the dictionary, x_hat summed
    mesh = make_mesh(1, 1, 2)
    ens = scale_build(pkg, mesh)
    check(ens._route(SCALE["batch"], False, False) == "autograd", "(1,1,2) route")
    full = scale_build(pkg, None)
    g_sh, _, _ = ens._grads(ens.state.params, ens.state.buffers, batches[0])
    g_ref, _, _ = full._grads(full.state.params, full.state.buffers, batches[0])
    n = SCALE["n_dict"] // 2
    rows = slice(mesh.coords[DICT_AXIS] * n, (mesh.coords[DICT_AXIS] + 1) * n)
    cos_d, rel_d = grads_close(torch, g_sh["encoder"], g_ref["encoder"][:, rows], "(1,1,2) g_enc rows")
    del full, g_sh, g_ref
    torch.cuda.empty_cache()
    run = timed_steps(torch, ens, batches, mesh)
    lrel = float(((run["losses"].cpu() - torch.tensor(refs["losses_autograd"])).abs()
                  / torch.tensor(refs["losses_autograd"]).abs()).max())
    check(lrel < 1e-3, f"(1,1,2) losses off the unsharded autograd run's by {lrel}")
    check(sum(run["launches"].values()) == 0, f"(1,1,2) launched {run['launches']}")
    res["dict_112"] = dict({k: v for k, v in run.items() if k != "losses"}, grad_cos=cos_d, grad_max_rel=rel_d,
                           loss_max_rel=lrel)
    del ens
    torch.cuda.empty_cache()
    save()

    # FISTA at config 3 on (1,2,1): the gradient step, then K_f on each
    # rank's rows and the update's sums over the data group
    from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

    mesh = make_mesh(1, 2, 1)
    fens = fista_scale_build(pkg).shard(mesh)
    x = fista_scale_batch(torch)
    fk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, aux = fens.step_batch(x)
    fens.state = make_fista_decoder_update(SCALE_FISTA["iters"])(fens.state, fens.local_batch(x), aux["c"], mesh=mesh)
    torch.cuda.synchronize()
    fista_s = time.perf_counter() - t0
    launches = fk.LAUNCHES["fista_solve"]
    check(launches == 1, f"rank {rank}: K_f launches {launches}")
    st = fens.full_state()
    if rank == 0:
        torch.save({"loss": loss["loss"].cpu(), "decoder": st.params["decoder"].cpu(),
                    "hessian": st.buffers["hessian_diag"].cpu()}, root / "fista_121.pt")
    res["fista_121"] = dict(launches=launches, seconds=fista_s, collective_bytes=mesh.stats["bytes"])
    del fens, st
    torch.cuda.empty_cache()
    save()

    # the sweep on (1,2,1): uninterrupted, then rank 1 SIGTERMed at chunk 0
    mesh_shape = (1, 2, 1)
    tk.reset_launches()
    t0 = time.perf_counter()
    sweep(scale_sweep_init(mesh_shape), scale_sweep_cfg(root, "sweep_full"), resume=False)
    res["sweep_full"] = dict(seconds=time.perf_counter() - t0, launches=dict(tk.LAUNCHES))
    save()
    if rank == 1:
        os.environ["SC_FAULT"] = "sigterm:chunk=0"
    t0 = time.perf_counter()
    try:
        sweep(scale_sweep_init(mesh_shape), scale_sweep_cfg(root, "sweep_pre"), resume=False)
        res["sweep_pre"] = dict(preempted=False)
    except Preempted:
        res["sweep_pre"] = dict(preempted=True, seconds=time.perf_counter() - t0)
    save()
    torch.distributed.destroy_process_group()
    return 75 if res["sweep_pre"]["preempted"] else 0


def fista_scale_build(pkg):
    return pkg.build_ensemble(pkg.FunctionalFista, 0, [{"l1_alpha": a} for a in FISTA_L1],
                              optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16",
                              activation_size=SCALE_FISTA["width"], n_dict_components=SCALE_FISTA["n_dict"])


def fista_scale_batch(torch):
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    gen = RandomDatasetGenerator(SCALE_FISTA["width"], 1024, SCALE_FISTA["batch"], 8, 0.996, False,
                                 key=SCALE_FISTA["seed"])
    return next(gen)


def phase_scaleout(torch, root: Path):
    """Scale-out at config 5's widths (see `SCALE`). Kernels first: K1 and K2
    at (M 4, B 2048, N 32768, D 1024), K3 at the data axis' local batch of
    1024, K_f at FISTA's local batch, each against its plain version. Then
    the world of one over NCCL here: meshes (1,1,1) and (1,1,1) without the
    dict cut, 3 steps each, bit-equal to the unsharded ensemble (K1 + K2
    launched). Then a world of two processes on the one card over gloo
    (``chip_smoke.py --scaleout-worker``): (2,1,1) every member the world of
    one's bits (params and moments; the losses within rtol 1e-6: torch sums
    K1's loss partials in an order it picks by the member count); (1,2,1)
    K1 + K3 on the local rows, the summed gradient held to the full batch's
    at K3's pins (cosine > 0.9999, max error < 1e-2 of the max: the same
    kernels on two halves of the rows, summed in another order) and the
    losses within rtol 1e-3 of the world of one's on that route (bf16
    compute); (1,1,2) autograd with the decode summed over the
    dict group, its gradient rows and losses held the same way; FISTA's step
    on (1,2,1); the sweep uninterrupted, then with rank 1 SIGTERMed at chunk
    0: both ranks checkpoint chunk 0 and exit 75. The preempted sweep then
    resumes here as a world of one (elastic: the fused-Adam route on the
    whole batch), and its export is held to the uninterrupted world of two's
    by the update since the checkpoint (export less the checkpoint's params):
    K3's cosine pin (> 0.9999), its relative L2 error under 1e-2, every
    element within a quarter of lr a step (Adam moves an element about lr
    a step; the two routes round their bf16 gradients apart, and Adam's
    normalization leaves ~0.07 lr a step of that per element on the card).
    FISTA's sharded step against this process' unsharded one: the losses
    within rtol 1e-5, the decoder within 4 lr everywhere (Adam's step on it
    before the update) and all but 1e-3 of it within 1e-6. The times of the
    world of two are gloo through host memory with both ranks on one card:
    not a multi-GPU figure. Returns the kernels-line rows."""
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.parallel import initialize_distributed, make_mesh
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
    from sparse_coding__tpu_torch.train.sweep import sweep

    t_phase = time.perf_counter()
    M_, B_, N_, D_ = len(SCALE["l1"]), SCALE["batch"], SCALE["n_dict"], SCALE["width"]
    check(tk.shapes_supported(N_, D_, B_) and tk.shapes_supported(N_, D_, B_ // 2), "config 5 off the kernels")
    g = torch.Generator(device="cuda").manual_seed(SCALE["seed"])
    rows = tied_kernel_rows(torch, tk, g, (M_, B_, N_, D_))
    rows.append(scale_k3_row(torch, tk, g, (M_, B_ // 2, N_, D_)))
    rows.append(fista_kernel_row(torch, fk, tf, dict(M=len(FISTA_L1), B=SCALE_FISTA["batch"] // 2,
                                                     N=SCALE_FISTA["n_dict"], D=SCALE_FISTA["width"],
                                                     iters=SCALE_FISTA["iters"]), 133, 16, 1e-3, 2, FISTA_L1))
    torch.cuda.empty_cache()

    # the world of one over NCCL, in this process
    check(initialize_distributed(f"file://{root / 'store1'}", 1, 0), "world of one did not start")
    backend = str(torch.distributed.get_backend())
    check(backend == "nccl", f"world of one on {backend}")
    batches = scale_batches(torch)
    ref = scale_build(pkg)
    ref_run = timed_steps(torch, ref, batches)
    check(ref_run["launches"]["tied_sae_fwd"] == SCALE["steps"] and
          ref_run["launches"]["tied_sae_bwd_adam"] == SCALE["steps"], f"unsharded {ref_run['launches']}")
    world1 = {"losses": ref_run["losses"].cpu().tolist(), "digests": member_digests(torch, ref)}
    one = {}
    for label, shard_dict in (("mesh_111", True), ("mesh_111_whole_dict", False)):
        mesh = make_mesh(1, 1, 1)
        ens = scale_build(pkg, mesh, shard_dict)
        run = timed_steps(torch, ens, batches, mesh)
        check(torch.equal(run["losses"], ref_run["losses"]), f"{label}: losses differ from unsharded")
        for a, b in zip(ens.state_dict()["state"].params.values(), ref.state_dict()["state"].params.values()):
            check(torch.equal(a, b), f"{label}: params differ from unsharded")
        check(member_digests(torch, ens) == world1["digests"], f"{label}: moments differ from unsharded")
        check(run["launches"] == ref_run["launches"], f"{label}: launches {run['launches']}")
        one[label] = {k: v for k, v in run.items() if k != "losses"}
        del ens
    torch.distributed.destroy_process_group()
    del ref
    torch.cuda.empty_cache()
    # the references on the other routes: fused grads + the port's Adam, and autograd
    for name, fused in (("losses_grads", "grads"), ("losses_autograd", False)):
        ens = scale_build(pkg)
        if fused == "grads":
            ens.fused_adam = None
        else:
            ens.fused = False
        world1[name] = torch.stack([ens.step_batch(b)[0]["loss"] for b in batches]).cpu().tolist()
        del ens
        torch.cuda.empty_cache()
    (root / "world1.json").write_text(json.dumps(world1))
    emit("scaleout_world1", backend=backend, unsharded={k: v for k, v in ref_run.items() if k != "losses"}, **one)

    # the world of two on the one card, over gloo
    scale_store(torch, root)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--scaleout-worker", str(r), "2",
                               str(root)], env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=SCALE["timeout"])[1])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    world2_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    check(codes == [75, 75], f"world of two exited {codes}: {[e[-3000:] for e in errs]}")
    res = [json.loads((root / f"r{r}.json").read_text()) for r in range(2)]
    check(all(r["sweep_pre"]["preempted"] for r in res), "the preempted sweep did not preempt both ranks")
    pre = root / "sweep_pre"
    check(sorted(p.name for p in pre.glob("ckpt_*")) == ["ckpt_0"] and (pre / "ckpt_0" / "shards").is_dir(),
          f"preempted checkpoints {sorted(p.name for p in pre.glob('ckpt_*'))}")
    cursors = [[e["cursor"] for e in read_events(pre / f"events.p{r}.jsonl") if e["event"] == "preempt"]
               for r in range(2)]
    check(cursors == [[0], [0]], f"preempt cursors {cursors}")
    emit("scaleout_world2", seconds=world2_s, transport="gloo through host memory, two ranks on one card "
         "(not a multi-GPU figure)", **{f"rank{r}": res[r] for r in range(2)})

    # the preempted sweep resumes as a world of one (elastic)
    tk.reset_launches()
    t0 = time.perf_counter()
    sweep(scale_sweep_init(None), scale_sweep_cfg(root, "sweep_pre"), resume=True)
    resume_s = time.perf_counter() - t0
    resume_launches = dict(tk.LAUNCHES)
    check(resume_launches["tied_sae_fwd"] > 0 and resume_launches["tied_sae_bwd_adam"] > 0,
          f"resume launches {resume_launches}")
    got = ckpt_lib.load_learned_dicts(pre / "_1" / "learned_dicts.pkl", verify=True)
    want = ckpt_lib.load_learned_dicts(root / "sweep_full" / "_1" / "learned_dicts.pkl", verify=True)
    base = ckpt_lib.restore_ensemble_checkpoint(pre / "ckpt_0")["ensembles"]["dictpar"]["state"].params
    steps_after = SCALE["sweep_rows"] // SCALE["batch"]
    held = {}
    for f in ("encoder", "encoder_bias"):
        check(all(ha == hb for (_a, ha), (_b, hb) in zip(got, want)), "export hyperparams")
        start = base[f].cuda()
        upd_got = torch.stack([getattr(a, f) for a, _ in got]) - start
        upd_want = torch.stack([getattr(b, f) for b, _ in want]) - start
        a, b = upd_got.double().flatten(), upd_want.double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        rel_l2 = float((a - b).norm() / b.norm())
        worst = float((a - b).abs().max())
        check(cos > 0.9999 and rel_l2 < 1e-2 and worst <= LR * steps_after / 4,
              f"elastic resume {f} update: cos {cos}, relative L2 {rel_l2}, max |diff| {worst}")
        held[f] = dict(update_cos=cos, update_rel_l2=rel_l2, max_abs_diff=worst)
    emit("scaleout_elastic_resume", seconds=resume_s, launches=resume_launches, steps_after_checkpoint=steps_after,
         sweep_full_launches_rank0=res[0]["sweep_full"]["launches"], **held)

    # FISTA's sharded step against this process' unsharded one
    fens = fista_scale_build(pkg)
    x = fista_scale_batch(torch)
    from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

    loss, aux = fens.step_batch(x)
    fens.state = make_fista_decoder_update(SCALE_FISTA["iters"])(fens.state, x, aux["c"])
    sh = torch.load(root / "fista_121.pt")
    lrel = float(((sh["loss"] - loss["loss"].cpu()).abs() / loss["loss"].cpu().abs()).max())
    ddiff = (sh["decoder"] - fens.state.params["decoder"].cpu()).abs()
    dshare = float((ddiff > 1e-6).float().mean())
    check(lrel < 1e-5 and float(ddiff.max()) <= 4 * LR and dshare < 1e-3,
          f"FISTA (1,2,1): loss rel {lrel}, decoder max |diff| {float(ddiff.max())}, share past 1e-6 {dshare}")
    emit("scaleout_fista", loss_max_rel=lrel, decoder_max_abs_diff=float(ddiff.max()), decoder_share_past_1em6=dshare,
         launches_by_rank=[r["fista_121"]["launches"] for r in res])
    del fens
    torch.cuda.empty_cache()
    emit("scaleout", seconds=time.perf_counter() - t_phase)

    # the kernels line: launches on the new paths (the world of two's rank 0)
    k1, k2, k3, kf = rows
    k1["launches"] = res[0]["model_211"]["launches"]["tied_sae_fwd"] + res[0]["data_121"]["launches"]["tied_sae_fwd"]
    k2["launches"] = res[0]["model_211"]["launches"]["tied_sae_bwd_adam"]
    k3["launches"] = res[0]["data_121"]["launches"]["tied_sae_bwd_grads"]
    kf["launches"] = res[0]["fista_121"]["launches"]
    for row in rows:
        row["path"] = "scaleout"
    return rows


def seqpar_peak(torch, fn, mesh=None):
    """``(fn(), seconds, peak allocated bytes above the start, mesh.stats'
    growth)`` of one call between two device synchronisations, after one
    warm-up call (the first call of a shape pays the library's setup)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    stats = dict(mesh.stats) if mesh is not None else {}
    out, seconds = timed(torch, fn)
    grown = {k: v - stats.get(k, 0) for k, v in mesh.stats.items()} if mesh is not None else {}
    return out, seconds, torch.cuda.max_memory_allocated() - before, grown


def phase_seqpar_world1(torch, root: Path, cfg, params, lang):
    """The sequence-parallel path in a world of one over NCCL, in this
    process (the degenerate ring and Ulysses, p = 1: no collective runs). At
    seq 8192: ring and Ulysses attention on random [1, 8192, 8, 64] f32
    q/k/v against dense attention (atol 2e-5), then layer 2's residual
    through `make_sequence_parallel_fn(attn="ring" | "ulysses")` against
    the dense forward's (atol 2e-3), each timed with its peak allocated
    bytes. Saves q/k/v and the tokens for the world of two; returns the
    dense references. Counts set to 0 around the phase: no hand-written
    kernel (JAX computes these in plain XLA)."""
    import numpy as np

    from sparse_coding__tpu_torch.lm import make_tensor_name, run_with_cache
    from sparse_coding__tpu_torch.lm.model import dense_attention
    from sparse_coding__tpu_torch.lm.ring_attention import ATTN_IMPLS, make_sequence_parallel_fn
    from sparse_coding__tpu_torch.parallel import initialize_distributed, make_mesh

    t_phase = time.perf_counter()
    S, layer = SEQPAR["seq"], HARVEST["layer"]
    name = make_tensor_name(layer, "residual")
    read_launches = zero_launches(torch)
    check(initialize_distributed(f"file://{root / 'store_seqpar1'}", 1, 0), "world of one did not start")
    backend = str(torch.distributed.get_backend())
    check(backend == "nccl", f"world of one on {backend}")
    mesh = make_mesh(1, 1, 1)
    g = torch.Generator(device="cuda").manual_seed(SEQPAR["attn_seed"])
    q, k, v = (torch.randn((1, S, cfg.n_heads, cfg.d_head), generator=g, device="cuda") for _ in range(3))
    torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu()}, root / "seqpar_qkv.pt")
    dense_attn, dense_attn_s, dense_attn_peak, _ = seqpar_peak(torch, lambda: dense_attention(q, k, v))
    res = {"dense": dict(attention_s=dense_attn_s, attention_peak_allocated_bytes=dense_attn_peak)}
    for impl in ("ring", "ulysses"):
        attn = ATTN_IMPLS[impl]("data", mesh=mesh)
        out, secs, peak, _ = seqpar_peak(torch, lambda: attn(q, k, v))
        err = float((out - dense_attn).abs().max())
        check(err <= SEQPAR["attn_atol"], f"{impl} attention (world of one) at seq {S}: max |Δ| {err} vs dense")
        res[impl] = dict(attention_max_abs_err=err, attention_s=secs, attention_peak_allocated_bytes=peak)
        del out
    del q, k, v
    tokens = lang.sample(SEQPAR["harvest_seqs"], S, seed=SEQPAR["tokens_seed"])
    np.save(root / "seqpar_tokens.npy", tokens)
    short = torch.from_numpy(tokens[:1]).cuda()
    with torch.no_grad():
        dense_cap, dense_s, dense_peak, _ = seqpar_peak(
            torch, lambda: run_with_cache(params, short, cfg, [name], stop_at_layer=layer + 1)[1][name])
    res["dense"].update(capture_s=dense_s, capture_tokens_per_s=S / dense_s, capture_peak_allocated_bytes=dense_peak)
    for impl in ("ring", "ulysses"):
        fn = make_sequence_parallel_fn(cfg, mesh, cache_names=[name], stop_at_layer=layer + 1, attn=impl)
        with torch.no_grad():
            out, secs, peak, _ = seqpar_peak(torch, lambda: fn(params, short)[1][name])
        err = float((out - dense_cap).abs().max())
        check(out.shape == dense_cap.shape and err <= SEQPAR["capture_atol"],
              f"{impl} capture (world of one) at seq {S}: {tuple(out.shape)}, max |Δ| {err} vs dense")
        res[impl].update(capture_max_abs_err=err, capture_s=secs, capture_tokens_per_s=S / secs,
                         capture_peak_allocated_bytes=peak)
        del out
    launches = read_launches()
    check(not launches, f"the sequence-parallel path launched hand-written kernels {launches}")
    check(mesh.stats["calls"] == 0, f"a world of one ran collectives {mesh.stats}")
    torch.distributed.destroy_process_group()
    emit("seqpar_world1", backend=backend, seq=S, layer=layer, loc="residual", heads=cfg.n_heads, d_head=cfg.d_head,
         attention_atol=SEQPAR["attn_atol"], capture_atol=SEQPAR["capture_atol"], launches=launches,
         seconds=time.perf_counter() - t_phase, **res)
    return {"attn": dense_attn.cpu(), "capture": dense_cap.cpu(), "tokens": tokens}


def seqpar_worker(argv) -> int:
    """``chip_smoke.py --seqpar-worker <rank> <world> <root>``: one rank of
    the sequence-parallel world of two on the one card (gloo through a file
    store in ``root``, the collectives staged through host memory). On this
    rank's half of the sequence: ring and Ulysses attention on the saved
    q/k/v, layer 2's residual of the first saved sequence by each strategy,
    then `make_activation_dataset(mesh=, seq_attn=)` of both saved
    sequences into ``root/seqpar_<strategy>`` (one sequence a chunk), the
    writes it made counted. Each rank's wall, tokens/s, `Mesh.stats` and
    peak allocated bytes, and the output shards, go to
    ``root/seqpar_r<rank>.pt``; its chunk windows to its own event log
    under ``root/seqpar_run``."""
    import numpy as np
    import torch

    from sparse_coding__tpu_torch.data import activations as tact
    from sparse_coding__tpu_torch.lm import config_for, make_tensor_name
    from sparse_coding__tpu_torch.lm.ring_attention import ATTN_IMPLS, make_sequence_parallel_fn
    from sparse_coding__tpu_torch.parallel import initialize_distributed, make_mesh
    from sparse_coding__tpu_torch.telemetry import RunTelemetry

    rank, world, root = int(argv[0]), int(argv[1]), Path(argv[2])
    t_init = time.perf_counter()
    check(initialize_distributed(f"file://{root / 'store_seqpar2'}", world, rank), "world of two did not start")
    check(torch.distributed.get_backend() == "gloo" and torch.cuda.current_device() == 0, "backend / device")
    mesh = make_mesh(1, world, 1)
    res = {"init_s": time.perf_counter() - t_init}
    cfg = config_for(SUBJECT["model"])
    params = torch.load(root / "subject.pt", map_location="cuda")
    S, layer = SEQPAR["seq"], HARVEST["layer"]
    name = make_tensor_name(layer, "residual")
    n, i = S // world, mesh.coords["data"]
    qkv = {key: t.cuda()[:, i * n:(i + 1) * n] for key, t in torch.load(root / "seqpar_qkv.pt").items()}

    def stats_since(before):
        return {k: mesh.stats[k] - before.get(k, 0) for k in mesh.stats}

    for impl in ("ring", "ulysses"):
        attn = ATTN_IMPLS[impl]("data", mesh=mesh)
        out, secs, peak, grown = seqpar_peak(torch, lambda: attn(qkv["q"], qkv["k"], qkv["v"]), mesh)
        res[f"attn_{impl}"] = dict(out=out.cpu(), seconds=secs, peak_allocated_bytes=peak, stats=grown)
        del out
    del qkv
    tokens = np.load(root / "seqpar_tokens.npy")
    short = torch.from_numpy(tokens[:1]).cuda()
    for impl in ("ring", "ulysses"):
        fn = make_sequence_parallel_fn(cfg, mesh, cache_names=[name], stop_at_layer=layer + 1, attn=impl)
        with torch.no_grad():
            out, secs, peak, grown = seqpar_peak(torch, lambda: fn(params, short)[1][name], mesh)
        res[f"capture_{impl}"] = dict(out=out.cpu(), seconds=secs, tokens_per_s=S / secs, peak_allocated_bytes=peak,
                                      stats=grown)
        del out
    writes = []
    real_save = tact.save_chunk

    def counted_save(folder, idx, *a, **kw):
        writes.append((Path(folder).name, int(idx)))
        return real_save(folder, idx, *a, **kw)

    tact.save_chunk = counted_save
    tel = RunTelemetry(out_dir=str(root / "seqpar_run"), run_name="seqpar_world2",
                       config={"seq": S, "world": world, "layer": layer})
    tel.run_start(mesh=mesh)
    chunk_gb = S * cfg.d_model * 2 / 1024**3  # one sequence a chunk
    try:
        for c, impl in enumerate(("ring", "ulysses")):
            before = dict(mesh.stats)
            torch.cuda.reset_peak_memory_stats()
            tel.chunk_start(c, epoch=0, position=c)
            _, secs = timed(torch, lambda: tact.make_activation_dataset(
                params, cfg, tokens, root / f"seqpar_{impl}", [layer], ["residual"], batch_size=1,
                chunk_size_gb=chunk_gb, mesh=mesh, seq_attn=impl, device="cuda"))
            tel.chunk_end(c, epoch=0, position=c)
            res[f"harvest_{impl}"] = dict(seconds=secs, tokens_per_s=tokens.size / secs,
                                          peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                                          stats=stats_since(before))
    finally:
        tact.save_chunk = real_save
    tel.run_end(status="ok")
    tel.close()
    res.update(writes=writes, stats=dict(mesh.stats), peak_allocated_bytes=torch.cuda.max_memory_allocated())
    torch.save(res, root / f"seqpar_r{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def phase_seqpar_world2(torch, root: Path, cfg, params, ref):
    """The sequence-parallel path in a world of two processes on the one
    card over gloo (``chip_smoke.py --seqpar-worker``; the subject's params
    from ``root/subject.pt``), 4096 tokens a rank: the gathered ring and
    Ulysses attention against this process' dense attention (atol 2e-5),
    the gathered captures against its dense capture (atol 2e-3), and each
    strategy's sharded store (2 sequences of 8192 tokens, one a chunk)
    against the single-card dense harvest of the same tokens, row for row
    in the single-card order (atol 2e-3), rank 0 its only writer. The times
    are gloo through host memory with both ranks on one card: not a
    multi-GPU figure. Also reckons, from the ranks' measured peaks, the
    longest sequence two ranks of each strategy could hold on this card."""
    import numpy as np

    from sparse_coding__tpu_torch.data.activations import make_activation_dataset
    from sparse_coding__tpu_torch.lm import model as lm_model

    t_phase = time.perf_counter()
    S, layer, world = SEQPAR["seq"], HARVEST["layer"], SEQPAR["world"]
    read_launches = zero_launches(torch)
    tokens = ref["tokens"]
    chunk_gb = S * cfg.d_model * 2 / 1024**3
    plain_dir, plain_s = timed(torch, lambda: make_activation_dataset(
        params, cfg, tokens, root / "seqpar_dense", [layer], ["residual"], batch_size=1, chunk_size_gb=chunk_gb,
        device="cuda"))
    plain = plain_dir[(layer, "residual")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--seqpar-worker", str(r), str(world),
                               str(root)], env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=SEQPAR["timeout"])[1])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    world_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    check(codes == [0] * world, f"sequence-parallel world of two exited {codes}: {[e[-3000:] for e in errs]}")
    res = [torch.load(root / f"seqpar_r{r}.pt") for r in range(world)]
    out = {}
    for impl in ("ring", "ulysses"):
        attn = torch.cat([r[f"attn_{impl}"].pop("out") for r in res], dim=1)
        a_err = float((attn - ref["attn"]).abs().max())
        check(a_err <= SEQPAR["attn_atol"], f"{impl} attention (world of two) at seq {S}: max |Δ| {a_err} vs dense")
        cap = torch.cat([r[f"capture_{impl}"].pop("out") for r in res], dim=1)
        c_err = float((cap - ref["capture"]).abs().max())
        check(cap.shape == ref["capture"].shape and c_err <= SEQPAR["capture_atol"],
              f"{impl} capture (world of two) at seq {S}: max |Δ| {c_err} vs dense")
        folder = root / f"seqpar_{impl}_l{layer}_residual"
        h_err, h_max = 0.0, 0.0
        for c in range(SEQPAR["harvest_seqs"]):
            got, want = np.load(folder / f"{c}.npy"), np.load(plain / f"{c}.npy")
            check(got.shape == want.shape == (S, cfg.d_model) and got.dtype == np.float16,
                  f"{impl} store chunk {c}: {got.shape} {got.dtype}")
            h_err = max(h_err, float(np.abs(got.astype(np.float32) - want.astype(np.float32)).max()))
            h_max = max(h_max, float(np.abs(want.astype(np.float32)).max()))
        check(h_err <= SEQPAR["capture_atol"], f"{impl} sharded store vs the single-card harvest: max |Δ| {h_err}")
        # the store's fp16 step at its largest value: the captures' f32
        # differences (~1e-6) flip some roundings by one step
        out[impl] = dict(attention_max_abs_err=a_err, capture_max_abs_err=c_err, store_max_abs_err=h_err,
                         store_max_abs_value=h_max)
    check(sorted(res[0]["writes"]) == sorted((f"seqpar_{impl}_l{layer}_residual", c) for impl in ("ring", "ulysses")
                                             for c in range(SEQPAR["harvest_seqs"])),
          f"rank 0 wrote {res[0]['writes']}")
    check(all(not r["writes"] for r in res[1:]), f"ranks past 0 wrote {[r['writes'] for r in res[1:]]}")
    launches = read_launches()
    check(not launches, f"the sequence-parallel path launched hand-written kernels {launches}")
    # the longest seq two ranks hold: the peak above the params grows with
    # (S/p)² (ring's score tile, Ulysses' H/p dense scores); two ranks share
    # the card's memory, less this process' own
    total = torch.cuda.get_device_properties(0).total_memory
    params_bytes = sum(t.numel() * t.element_size() for t in lm_model.tree_leaves(params).values())
    free_for_two = total - torch.cuda.memory_reserved()
    reckoned = {}
    for impl in ("ring", "ulysses"):
        peak = max(r[f"capture_{impl}"]["peak_allocated_bytes"] for r in res)
        scale = max(1.0, (free_for_two / world - params_bytes) / max(1, peak))
        longest = int(S * math.sqrt(scale)) // 1024 * 1024
        heads, rows = (cfg.n_heads, longest // world) if impl == "ring" else (cfg.n_heads // world, longest)
        reckoned[impl] = dict(peak_allocated_bytes_at_seq=peak, longest_seq=longest,
                              score_tile_bytes_at_longest=heads * rows * (longest // world if impl == "ring"
                                                                          else longest) * 4)
    ranks = {f"rank{r}": {k: v for k, v in res[r].items() if k != "writes"} for r in range(world)}
    emit("seqpar_world2", seq=S, world=world, tokens_per_rank=S // world, layer=layer, loc="residual",
         transport="gloo through host memory, two ranks on one card (not a multi-GPU figure)", seconds=world_s,
         plain_harvest_s=plain_s, plain_harvest_tokens_per_s=tokens.size / plain_s, launches=launches,
         reckoned=reckoned, card_total_bytes=total, phase_seconds=time.perf_counter() - t_phase, **out, **ranks)


def phase_runtools(torch, runs: dict):
    """The run tools (ROADMAP A9's first group) over the run dirs the smoke
    wrote (`KEPT_RUNS`: the sweep's, basic_l1_sweep's, the serving process'
    and the replicated tier's, the scale-out and sequence-parallel worlds
    of two's per-process logs). Host only. `build_ledger` over the sweep's
    run dir, its ``step`` spans summing to what `phase_sweep_train` reads;
    every run's `render_markdown`, ledger and `render_ledger`; the
    `timeline` CLI writing a Chrome trace that is read back; the SLO over
    the serving process' events; one `monitor` render at a fixed ``now``;
    `chunk_skew_windows` over both worlds of two. Prints sizes and
    seconds."""
    import contextlib
    import io

    from sparse_coding__tpu_torch import timeline
    from sparse_coding__tpu_torch.telemetry import read_events
    from sparse_coding__tpu_torch.telemetry.goodput import build_ledger, render_ledger, to_chrome_trace
    from sparse_coding__tpu_torch.telemetry.monitor import RunMonitor, render
    from sparse_coding__tpu_torch.telemetry.multihost import chunk_skew_windows
    from sparse_coding__tpu_torch.telemetry.report import load_run, render_markdown
    from sparse_coding__tpu_torch.telemetry.slo import evaluate_run_dir, render_slo

    t_phase = time.perf_counter()
    want = {"sweep", "basic_l1_sweep", "serve_drain", "serve_tier", "scaleout_world2", "seqpar_world2"}
    check(want <= set(runs), f"kept run dirs {sorted(runs)}")
    per_run = {}
    for name, d in sorted(runs.items()):
        t0 = time.perf_counter()
        md = render_markdown(load_run(d))
        t1 = time.perf_counter()
        ledger = build_ledger(d)
        text = render_ledger(ledger)
        trace = to_chrome_trace(ledger)
        t2 = time.perf_counter()
        check(md.startswith("# Run report") and ledger["wall_seconds"] > 0 and trace["traceEvents"],
              f"{name}: report / ledger / trace empty")
        per_run[name] = dict(report_chars=len(md), report_s=t1 - t0, ledger_wall_seconds=ledger["wall_seconds"],
                             goodput_frac=ledger["goodput_frac"], ledger_chars=len(text),
                             trace_events=len(trace["traceEvents"]), ledger_s=t2 - t1,
                             n_processes=ledger["n_processes"])
    sweep_events = read_events(runs["sweep"] / "events.jsonl")
    step_read = span_seconds(sweep_events, "step")
    ledger = build_ledger(runs["sweep"])
    step_ledger = sum(s["seconds"] for s in ledger["spans"] if s["category"] == "step" and not s.get("derived"))
    check(abs(step_ledger - step_read) <= 1e-3 * max(1.0, step_read),
          f"the ledger's step spans {step_ledger} s vs the sweep's {step_read} s")
    trace_path = runs["sweep"] / "timeline_trace.json"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = timeline.main([str(runs["sweep"]), "--trace", str(trace_path)])
    timeline_s = time.perf_counter() - t0
    reread = json.loads(trace_path.read_text())
    check(rc == 0 and reread["traceEvents"], f"timeline exited {rc}")
    t0 = time.perf_counter()
    slo = evaluate_run_dir(runs["serve_drain"], RUNTOOLS_SLO)
    slo_text = render_slo(slo)
    slo_s = time.perf_counter() - t0
    check(slo["n_evaluated"] >= 1, f"the SLO evaluated nothing: {slo_text}")
    mon = RunMonitor(runs["seqpar_world2"])
    mon.poll()
    last_ts = max(e.get("ts", 0) for f in runs["seqpar_world2"].rglob("*.jsonl") for e in read_events(f))
    mon_text = render(mon, now=last_ts + 5.0)
    skew = {}
    for name in ("scaleout_world2", "seqpar_world2"):
        events = load_run(runs[name])["events"]
        windows = chunk_skew_windows(events)
        check(windows, f"{name}: no chunk window seen by two processes")
        skew[name] = dict(windows=len(windows), max_spread_s=max(w["spread"] for w in windows),
                          processes=sorted({int(e.get("process_index", 0)) for e in events}))
    emit("runtools", runs=per_run, sweep_step_span_s=step_read, ledger_step_span_s=step_ledger,
         ledger_step_category_s=ledger["categories"].get("step"), timeline_s=timeline_s,
         trace_bytes=trace_path.stat().st_size, trace_events=len(reread["traceEvents"]),
         slo_verdict=slo["verdict"], slo_evaluated=slo["n_evaluated"], slo_failed=slo["n_failed"], slo_s=slo_s,
         monitor_lines=len(mon_text.splitlines()), skew=skew, seconds=time.perf_counter() - t_phase)


def profiling_store(torch, root: Path) -> dict:
    """The profiling sweep's store under ``root/act``, drawn on the card by a
    seeded `RandomDatasetGenerator`: 2 fp16 chunks of 65,536 rows at D 512.
    Returns its repair config (`data.scrub`'s synthetic schema)."""
    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    gen = dict(PROFILING["generator"])
    seed = gen.pop("seed")
    spec = dict(n_chunks=PROFILING["chunks"], chunk_size_gb=PROFILING["chunk_size_gb"], activation_width=D)
    generate_synthetic_chunks(RandomDatasetGenerator(**gen, key=seed, device="cuda"), root / "act", **spec)
    return {"kind": "synthetic", "generator": {**gen, "class": "RandomDatasetGenerator", "seed": seed},
            "dtype": "float16", **spec}


def profiling_cfg(out: str):
    """The profiling sweep's config; folders relative to the run's working
    directory, so a copy of the tree keeps its lineage joins."""
    from sparse_coding__tpu_torch.utils.config import SyntheticEnsembleArgs

    return SyntheticEnsembleArgs(
        use_synthetic_dataset=True, activation_width=D, n_ground_truth_components=1024, feature_num_nonzero=8,
        feature_prob_decay=0.996, n_chunks=PROFILING["chunks"], chunk_size_gb=PROFILING["chunk_size_gb"],
        n_epochs=1, batch_size=B, dataset_folder="act", output_folder=out, seed=0,
    )


def profiling_init(cfg):
    """Config 2's tied ensemble alone (8 members, Adam with bf16 mu, bf16
    compute): K1 + K2 every step."""
    import sparse_coding__tpu_torch as pkg

    ens = pkg.build_ensemble(pkg.FunctionalTiedSAE, 0, [{"l1_alpha": x} for x in L1_GRID],
                             optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
                             compute_dtype="bfloat16", activation_size=D, n_dict_components=N)
    return ([(ens, {"batch_size": cfg.batch_size, "dict_size": N}, "adam")], ["dict_size"], ["l1_alpha"],
            {"l1_alpha": L1_GRID, "dict_size": [N]})


def cli(main_fn, argv):
    """``(exit code, stdout)`` of a CLI's ``main(argv)`` run in-process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def trace_kernel_counts(path: Path) -> dict:
    """Executions of each wrapper's kernel in a window's Chrome trace (its
    ``kernel`` records by demangled name, `_torch_trace.SYMBOLS`)."""
    from _torch_trace import kernel_counts

    names = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return kernel_counts(names)


def phase_profiling(torch, root: Path) -> dict:
    """ROADMAP A9's profiling group on the card, at config 2's full width.

    The sweep driver over 2 chunks twice (``SC_COST_CAPTURE=full`` both
    times): a control, then with ``SC_TRACE_WINDOW`` over chunk 1. The
    window's Chrome trace holds K1 and K2 records, counted beside the
    wrappers' between the window's edges (a shortfall warns naming C3); the
    capture's ``compile`` cost equals `kernel_work`'s K1 + K2 at that shape
    and at the captured step's code nnz (the kernel rows' count), printed
    beside the dense-code count;
    the report renders the step on the roofline with the train loop's
    CUDA-event step ms. Then an anomaly run with a NaN member fires its
    trigger once, and `transfer_audit` wraps `ensemble_train_loop` on a
    graph-route chunk under sync-debug mode ``"error"`` (passes), and over a
    planted ``.item()`` (raises `TransferViolation`). Returns what
    `phase_lineage_scrub` needs."""
    import contextlib
    import warnings

    from _torch_trace import trace_shortfall
    from sparse_coding__tpu_torch.data.chunks import ChunkStore
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.telemetry import (
        AnomalyGuard,
        AnomalyPolicy,
        RunTelemetry,
        TraceTrigger,
        TransferViolation,
        read_events,
        transfer_audit,
    )
    from sparse_coding__tpu_torch.telemetry import profiling as tprof
    from sparse_coding__tpu_torch.telemetry.report import _fmt, load_run, render_markdown
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
    from sparse_coding__tpu_torch.train.sweep import sweep
    from sparse_coding__tpu_torch.utils.logging import MetricLogger
    from sparse_coding__tpu_torch.utils.trace import TRACE_FILE

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    check(tprof.peak_tflops(kind) * 1e12 == PEAK_BF16_FLOPS and tprof.hbm_gbps(kind) * 1e9 == PEAK_BYTES,
          f"the port's peak table for {kind} is not the kernel table's")
    repair = profiling_store(torch, root)
    steps_chunk = int(PROFILING["chunk_size_gb"] * 1024**3 // (D * 2)) // B
    runs = {}
    # the wrappers' counts at the window's edges: read where the trigger
    # opens it and where it closes it, the window's launches their difference
    edges = {}
    start0, stop0 = TraceTrigger._start, TraceTrigger._stop

    def start_read(self, *a, **kw):
        started = start0(self, *a, **kw)
        if started is not None:
            edges["start"] = dict(tk.LAUNCHES)
        return started

    def stop_read(self, *a, **kw):
        if self.active:
            edges["stop"] = dict(tk.LAUNCHES)
        return stop0(self, *a, **kw)

    for name, env in (("control", {"SC_COST_CAPTURE": "full"}),
                      ("window", {"SC_COST_CAPTURE": "full", "SC_TRACE_WINDOW": PROFILING["window"]})):
        tk.reset_launches()
        TraceTrigger._start, TraceTrigger._stop = start_read, stop_read
        try:
            with environ(env), contextlib.chdir(root):
                t0 = time.perf_counter()
                sweep(profiling_init, profiling_cfg(f"out_{name}"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            TraceTrigger._start, TraceTrigger._stop = start0, stop0
        events = read_events(root / f"out_{name}" / "events.jsonl")
        runs[name] = dict(wall_s=wall, launches={k: v for k, v in tk.LAUNCHES.items() if v},
                          chunk_s=[e["seconds"] for e in events if e["event"] == "chunk_end"], events=events)
        check(runs[name]["launches"] == {"tied_sae_fwd": 2 * steps_chunk, "tied_sae_bwd_adam": 2 * steps_chunk},
              f"{name} sweep launches {runs[name]['launches']}")
    events = runs["window"]["events"]
    traces = [e for e in events if e["event"] == "trace"]
    check([(t["reason"], t["start_step"], t["stop_step"]) for t in traces]
          == [("step_window", steps_chunk, 2 * steps_chunk)], f"trace events {traces}")
    check(not [e for e in runs["control"]["events"] if e["event"] == "trace"], "the control run traced")
    trace_file = root / traces[0]["dir"] / TRACE_FILE
    in_trace = {k: v for k, v in trace_kernel_counts(trace_file).items() if v}
    check(set(edges) == {"start", "stop"}, f"the window's edges were not read: {sorted(edges)}")
    window_launches = {k: edges["stop"].get(k, 0) - edges["start"].get(k, 0) for k in ("tied_sae_fwd",
                                                                                       "tied_sae_bwd_adam")}
    check(all(v > 0 for v in window_launches.values()), f"the wrappers counted no launch in the window: "
          f"{window_launches}")
    check(in_trace.get("tied_sae_fwd", 0) > 0 and in_trace.get("tied_sae_bwd_adam", 0) > 0,
          f"the window's trace holds no K1 or K2 record: {in_trace}")
    short = trace_shortfall(in_trace, window_launches)
    if short:
        warnings.warn(f"ROADMAP C3: the window's trace missed launches (trace, wrappers): {short}")
    compiles = [e for e in events if e["event"] == "compile"]
    check([c["name"] for c in compiles] == ["ensemble.step_scan"], f"compile events {compiles}")
    cost = compiles[0]["cost"]
    nnz = cost.get("code_nnz")
    check(nnz is not None and 0 < nnz < M * B * N, f"the capture recorded no code nnz: {cost}")
    k1 = tk.kernel_work("tied_sae_fwd", M, B, N, D, nnz)
    k2 = tk.kernel_work("tied_sae_bwd_adam", M, B, N, D, nnz, mu_bytes=2)
    check((cost["flops"], cost["bytes_accessed"]) == (k1[0] + k2[0], k1[1] + k2[1]),
          f"the capture's cost {cost} is not K1 + K2's work at its code nnz {k1}, {k2}")
    dense = [tk.kernel_work(k, M, B, N, D, **kw) for k, kw in (("tied_sae_fwd", {}),
                                                                ("tied_sae_bwd_adam", {"mu_bytes": 2}))]
    dense_flops = float(sum(f for f, _ in dense))
    check(cost.get("pool_bytes", 0) > 0, f"SC_COST_CAPTURE=full recorded no pool bytes: {cost}")
    gauges = [e for e in events if e["event"] == "snapshot"][-1]["gauges"]
    step_ms = gauges.get("perf.ensemble.step_scan.step_ms")
    check(step_ms is not None and step_ms > 0, f"no step-time gauge: {sorted(gauges)}")
    rl = tprof.roofline_summary(cost["flops"], cost["bytes_accessed"], kind, seconds=step_ms / 1e3)
    rl_dense = tprof.roofline_summary(dense_flops, cost["bytes_accessed"], kind, seconds=step_ms / 1e3)
    md = render_markdown(load_run(root / "out_window"))
    sec = md[md.index("## Performance attribution"):].split("\n## ")[0]
    row = [ln for ln in sec.splitlines() if ln.startswith("| ensemble.step_scan ")]
    check(row and all(f"| {_fmt(rl[k])} |" in row[0] for k in ("attainable_tflops", "achieved_fraction"))
          and f"| {rl['bound']} |" in row[0], f"the report's row {row} against {rl}")

    # the anomaly trigger: a NaN member, two chunk passes, one capture
    store = ChunkStore(root / "act")
    chunk0, chunk1 = store.load(0, device="cuda"), store.load(1, device="cuda")
    ens = profiling_init(profiling_cfg("unused"))[0][0][0]
    with torch.no_grad():
        ens.state.params["encoder"][M // 2].fill_(float("nan"))
    adir = root / "anomaly"
    tel = RunTelemetry(out_dir=str(adir), run_name="anomaly")
    trigger = TraceTrigger(telemetry=tel, out_dir=str(adir))
    guard = AnomalyGuard(telemetry=tel, out_dir=str(adir), policy=AnomalyPolicy(action="warn"), trace_trigger=trigger)
    logger = MetricLogger(out_dir=str(adir), run_name="anomaly", on_flush=guard.observe)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ensemble_train_loop(ens, chunk0, batch_size=B, key=1, logger=logger, telemetry=tel)
        fired = trigger.active
        ensemble_train_loop(ens, chunk1, batch_size=B, key=2, logger=logger, telemetry=tel)
        trigger.on_step(2 * steps_chunk)
    logger.close()
    tel.close()
    aevents = read_events(adir / "events.jsonl")
    anomalies = [e for e in aevents if e["event"] == "anomaly"]
    atraces = [e for e in aevents if e["event"] == "trace"]
    check(fired and len(atraces) == 1 and len(anomalies) >= 2 and anomalies[0]["trace_dir"] == atraces[0]["dir"]
          and all(a.get("trace_dir") is None for a in anomalies[1:]) and M // 2 in anomalies[0]["models"],
          f"anomaly trigger: fired {fired}, traces {atraces}, anomalies {anomalies}")
    anomaly_trace = trace_kernel_counts(Path(atraces[0]["dir"]) / TRACE_FILE)
    del ens, guard

    # the transfer audit over a graph-route chunk (both routes' graphs
    # captured first: the audit reads the replays' loop)
    ens = profiling_init(profiling_cfg("unused"))[0][0][0]
    logger = MetricLogger(out_dir=str(root / "audit"), run_name="audit")
    ensemble_train_loop(ens, chunk0, batch_size=B, key=1, logger=logger)
    ensemble_train_loop(ens, chunk0, batch_size=B, key=2, logger=logger, progress_callback=lambda i, n: None)
    captures = ens.captures
    mode_before = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    with transfer_audit():
        audit_mode = torch.cuda.get_sync_debug_mode()
        ensemble_train_loop(ens, chunk1, batch_size=B, key=3, logger=logger)
    audit_s = time.perf_counter() - t0
    check(audit_mode == 2 and torch.cuda.get_sync_debug_mode() == mode_before and ens.captures == captures,
          f"audit mode {audit_mode}, after {torch.cuda.get_sync_debug_mode()}, captures {ens.captures}")
    caught = None
    try:
        with transfer_audit():
            ensemble_train_loop(ens, chunk1, batch_size=B, key=4, logger=logger,
                                progress_callback=lambda i, n: ens.state.params["encoder"].sum().item())
    except TransferViolation as e:
        caught = str(e)
    check(caught is not None and "Tensor.item" in caught, f"the planted .item() was not caught: {caught}")
    logger.close()
    del ens, chunk0, chunk1
    emit("profiling", config="BASELINE config 2", chunks=PROFILING["chunks"], steps_per_chunk=steps_chunk,
         window=PROFILING["window"], wall_s={"sweep_train (3 chunks, 2 ensembles)": PHASE_WALL.get("sweep_train"),
                                             "control": runs["control"]["wall_s"], "window": runs["window"]["wall_s"]},
         chunk_s={k: v["chunk_s"] for k, v in runs.items()}, launches=runs["window"]["launches"],
         window_launches=window_launches, trace_kernels=in_trace, trace_short=short,
         trace_bytes=trace_file.stat().st_size, trace_start_s=traces[0]["start_s"], trace_stop_s=traces[0]["stop_s"],
         cost=cost, roofline=rl, step_ms=step_ms,
         dense_code=dict(flops=dense_flops, achieved_fraction=rl_dense.get("achieved_fraction"),
                         achieved_tflops=rl_dense.get("achieved_tflops")),
         anomaly=dict(anomalies=len(anomalies), traces=len(atraces), trace_kernels={k: v for k, v in
                                                                                      anomaly_trace.items() if v}),
         audit=dict(passed=True, seconds=audit_s, sync_debug_mode=audit_mode, planted=caught[:120]),
         seconds=time.perf_counter() - t_phase)
    return {"repair": repair}


def lineage_verify_root(root: Path) -> dict:
    """`verify_graph` at the digest tier over every artifact under ``root``
    (the harvest's stores, runs, checkpoints and exports): nodes, edges,
    failures and seconds."""
    from sparse_coding__tpu_torch.telemetry.provenance import build_graph, verify_graph

    t0 = time.perf_counter()
    graph = build_graph([root])
    t1 = time.perf_counter()
    failures = verify_graph(graph, "digest")
    t2 = time.perf_counter()
    failing = [(i, n["verify"]) for i, n in sorted(graph.nodes.items()) if str(n.get("verify", "")).startswith("FAIL")]
    return dict(nodes=len(graph.nodes), edges=len(graph.edges), verified=sum(1 for n in graph.nodes.values()
                                                                             if n.get("verify")),
                failures=failures, failing=failing[:10], tainted=len(graph.tainted()),
                types={t: sum(1 for n in graph.nodes.values() if n["type"] == t)
                       for t in sorted({n["type"] for n in graph.nodes.values()})},
                build_s=t1 - t0, verify_s=t2 - t1)


def phase_lineage_scrub(torch, root: Path, repair: dict, harvest_lineage: dict):
    """The lineage graph and the scrub on a copy of the profiling sweep's
    store, run dir and export: ``lineage check`` exits 0; one byte of chunk
    1 flipped, ``scrub`` exits 1 and quarantines it; ``lineage blast
    chunk:act#1`` names the export and ``lineage check`` exits 1; ``scrub
    --repair`` with the store's synthetic config (drawn again on the card)
    exits 0 with the chunk bit-equal to the original, and ``lineage check``
    exits 0. Beside it the digest-tier `verify_graph` over the harvest root
    (`lineage_verify_root`, run before that root went away)."""
    from sparse_coding__tpu_torch import lineage, scrub
    from sparse_coding__tpu_torch.data.chunks import chunk_path

    t_phase = time.perf_counter()
    copy = root / "lineage_copy"
    for sub in ("act", "out_window"):
        shutil.copytree(root / sub, copy / sub)
    store = copy / "act"
    times = {}

    def step(name, fn, argv):
        t0 = time.perf_counter()
        rc, out = cli(fn, argv)
        times[name] = time.perf_counter() - t0
        return rc, out

    rc_clean, _ = step("check_clean", lineage.main, ["check", str(copy)])
    check(rc_clean == 0, f"lineage check on the sweep's tree exited {rc_clean}")
    target = chunk_path(store, 1)
    original = target.read_bytes()
    raw = bytearray(original)
    raw[len(raw) // 2] ^= 0x01
    target.write_bytes(bytes(raw))
    rc_scrub, out_scrub = step("scrub", scrub.main, [str(store)])
    check(rc_scrub == 1 and (store / "quarantine" / "sc_quarantine.1.json").exists() and not target.exists(),
          f"scrub exited {rc_scrub}: {out_scrub[-500:]}")
    rc_blast, blast = step("blast", lineage.main, ["blast", "chunk:act#1", str(copy)])
    export_id = "export:out_window/_1/learned_dicts.pkl"
    check(rc_blast == 1 and export_id in blast and "tainted: quarantined" in blast, f"blast exited {rc_blast}: {blast}")
    rc_taint, taint = step("check_tainted", lineage.main, ["check", str(copy)])
    check(rc_taint == 1 and "chunk:act#1" in taint, f"lineage check over the taint exited {rc_taint}: {taint}")
    (copy / "repair.json").write_text(json.dumps(repair))
    rc_repair, out_repair = step("repair", scrub.main, [str(store), "--repair", str(copy / "repair.json")])
    check(rc_repair == 0, f"scrub --repair exited {rc_repair}: {out_repair[-800:]}")
    bit_equal = target.read_bytes() == original
    check(bit_equal, "the repaired chunk is not the original's bits")
    rc_after, after = step("check_repaired", lineage.main, ["check", str(copy)])
    check(rc_after == 0, f"lineage check after the repair exited {rc_after}: {after}")
    emit("lineage_scrub", exits=dict(check=rc_clean, scrub=rc_scrub, blast=rc_blast, check_tainted=rc_taint,
                                     repair=rc_repair, check_repaired=rc_after),
         blast_names_export=True, repaired_bit_equal=bit_equal, chunk_bytes=len(original), seconds_by_step=times,
         harvest_root=harvest_lineage, seconds=time.perf_counter() - t_phase)
    check(harvest_lineage["failures"] == 0, f"verify_graph over the harvest root: {harvest_lineage['failing']}")


def phase_features(torch, run_dir: Path):
    """The ``features`` CLI over `basic_l1_sweep`'s run dir (its snapshots
    and events, kept by `keep_run`): exit 0, and each snapshot's aggregates
    are the run's ``feature_stats`` flush events'."""
    from sparse_coding__tpu_torch import features
    from sparse_coding__tpu_torch.telemetry import read_events

    t0 = time.perf_counter()
    rc, out = cli(features.main, [str(run_dir), "--json"])
    check(rc == 0, f"features --json exited {rc}")
    info = json.loads(out)
    rc_text, text = cli(features.main, [str(run_dir)])
    check(rc_text == 0 and text.startswith("feature surface"), f"features exited {rc_text}: {text[:300]}")
    events = read_events(run_dir / "events.jsonl")
    flushes = [e for e in events if e["event"] == "feature_stats"]
    spans = [e for e in events if e["event"] == "span" and e["category"] == "feature_flush"]
    check([s["gen"] for s in info["snapshots"]] == [e["gen"] for e in flushes] and len(spans) >= len(flushes),
          f"snapshots {[s['gen'] for s in info['snapshots']]} vs flushes {[e['gen'] for e in flushes]}")
    worst = max(abs(s[k] - e[k]) for s, e in zip(info["snapshots"], flushes) for k in ("dead_frac", "gini", "hot_frac"))
    check(worst <= 1e-6, f"the CLI's aggregates differ from the flush events' by {worst}")
    emit("features", snapshots=len(info["snapshots"]), flush_spans=len(spans), latest=info["latest"],
         dead=info["dead"]["count"], drift=info["drift"], max_abs_diff_vs_events=worst,
         seconds=time.perf_counter() - t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # plain versions and references in exact f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--sweep-worker"]:
        return sweep_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--bls-worker"]:
        return bls_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--fleet-worker"]:
        return fleet_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--harvest-worker"]:
        return harvest_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--serve-worker"]:
        return serve_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--big-batch-worker"]:
        return big_batch_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--scaleout-worker"]:
        return scaleout_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--seqpar-worker"]:
        return seqpar_worker(sys.argv[2:])
    sys.path.insert(0, str(REPO / "tests"))  # _torch_moments, _torch_trace: helpers the CUDA tests share
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    started = time.perf_counter()
    runs_root = tempfile.TemporaryDirectory(prefix="sc_chip_smoke_runs_")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", name=name, count=count, torch=torch.__version__, cuda=torch.version.cuda,
         nvidia_smi=smi)

    t0 = time.perf_counter()
    _build.load()
    ptxas = {k: parse_ptxas(v) for k, v in _build.ptxas_log().items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    # the wgmma mainloop's kernels: registers, spills (ptxas) and, from the
    # built libraries' own plan, the stages and dynamic shared memory of
    # each width and number of int8 moment tiers
    emit("wgmma_kernels", plans=wgmma_plans(_build.load()),
         ptxas=[dict(f, library=lib) for lib in ("tied_sae_bwd", "tied_sae_bwd_rc")
                for f in ptxas[lib] if f["function"].startswith("wg_bwd_kernel")])

    def drive(cfg):
        """A path's main run and its export; the launch counts of the run."""
        torch.cuda.empty_cache()
        ens, gen, eval_batch, tmp, store, launches = phase_train(torch, pkg, cfg)
        phase_eval_export(torch, cfg, ens, gen, eval_batch, tmp)
        del ens, gen, eval_batch
        torch.cuda.empty_cache()
        phase_loop_wall(torch, pkg, cfg, store)
        tmp.cleanup()
        torch.cuda.empty_cache()
        return launches

    def label(rows_, cfg, launches, shape=None):
        for row in rows_:
            row.update(path=cfg["path"], launches=launches[row["name"]])
            if shape:
                row["shape"] = shape
        return rows_

    tied_shape = f"M={M},B={B},N={N},D={D}"
    small_tied = dict(hparams=[{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], activation_size=128,
                      n_dict_components=512)
    small_topk = dict(hparams=[{"sparsity": 7}, {"sparsity": 31}], d_activation=128, n_features=512,
                      sparsity_cap=31)

    # tied-SAE L1-sweep path
    rows = phase_kernels(torch, tk)
    torch.cuda.empty_cache()
    phase_small_parity(torch, pkg, pkg.FunctionalTiedSAE, optimizer_kwargs=TIED["build"]["optimizer_kwargs"],
                       **small_tied)
    peak, graph_peak = {}, {}
    peak["tied"], graph_peak["tied"] = phase_step_time(torch, pkg, TIED)
    phase_graph_parity(torch, pkg, TIED)
    rows = label(rows, TIED, drive(TIED), tied_shape)

    # the same at the capacity setting: K1n + K2 rebuilding the code
    capacity_rows = phase_capacity_kernels(torch, tk)
    torch.cuda.empty_cache()
    phase_small_parity(torch, pkg, pkg.FunctionalTiedSAE, optimizer_kwargs=CAPACITY_ADAM,
                       env=TIED_CAPACITY["env"], **small_tied)
    peak["tied_capacity"], graph_peak["tied_capacity"] = phase_step_time(torch, pkg, TIED_CAPACITY)
    phase_graph_parity(torch, pkg, TIED_CAPACITY)
    rows += label(capacity_rows, TIED_CAPACITY, drive(TIED_CAPACITY), tied_shape)

    # TopK k-sweep path (BASELINE config 4), then at the capacity setting
    torch.cuda.empty_cache()
    topk_rows, topk_capacity_rows = phase_topk_kernels(torch, tk, kk)
    torch.cuda.empty_cache()
    phase_small_parity(torch, pkg, pkg.TopKEncoderApprox, optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
                       **small_topk)
    phase_small_parity(torch, pkg, pkg.TopKEncoderApprox, optimizer_kwargs=CAPACITY_ADAM,
                       env=TOPK_CAPACITY["env"], **small_topk)
    rows += label(topk_rows, TOPK, drive(TOPK))
    peak["topk"], graph_peak["topk"] = phase_step_time(torch, pkg, TOPK, reps=10)
    phase_graph_parity(torch, pkg, TOPK)
    rows += label(topk_capacity_rows, TOPK_CAPACITY, drive(TOPK_CAPACITY))
    peak["topk_capacity"], graph_peak["topk_capacity"] = phase_step_time(torch, pkg, TOPK_CAPACITY, reps=10)
    phase_graph_parity(torch, pkg, TOPK_CAPACITY)

    # FISTA dictionary path (BASELINE config 3): the gradient step, then K_f
    torch.cuda.empty_cache()
    fista_rows = phase_fista_kernels(torch, fk, tf)
    torch.cuda.empty_cache()
    phase_fista_small_parity(torch, pkg, fk)
    ens, gen, eval_batch, tmp, launches = phase_fista_train(torch, pkg, FISTA)
    phase_eval_export(torch, FISTA, ens, gen, eval_batch, tmp)
    tmp.cleanup()
    del ens, gen, eval_batch
    torch.cuda.empty_cache()
    phase_fista_step(torch, pkg, FISTA)
    rows += label(fista_rows[:2], FISTA, launches)

    # the packs on the tied path's graph, then the FISTA driver basic_l1_sweep
    # (BASELINE config 1): K_f at its shape, killed and resumed bit for bit
    torch.cuda.empty_cache()
    phase_health_graph(torch, pkg, tf)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_bls_") as bls_root:
        bls_launches, control = phase_basic_l1_sweep_train(torch, tf, Path(bls_root))
        keep_run("basic_l1_sweep", Path(bls_root) / "bls_a", Path(runs_root.name),
                 patterns=("*.jsonl", "feature_stats.*.npz"))
        torch.cuda.empty_cache()
        phase_basic_l1_sweep_resume(torch, Path(bls_root), control)
        # the fleet scheduler (ROADMAP A9's fleet group) over the same driver:
        # 2 items packed from bls_a's watermark, two worker processes, a
        # killed worker's item resumed by the other, then serve and sync
        torch.cuda.empty_cache()
        fleet_launches = phase_fleet(torch, tf, Path(bls_root), control)
    bls_row = dict(fista_rows[2], path="basic_l1_sweep", launches=bls_launches)
    rows.append(bls_row)

    # the sweep driver (BASELINE config 2's widths): K1 + K2 and K1 + K3,
    # then a preempted and resumed run held to the uninterrupted one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_sweep_") as sweep_root:
        export = phase_sweep_train(torch, Path(sweep_root))
        keep_run("sweep", Path(sweep_root) / "out_a", Path(runs_root.name))
        torch.cuda.empty_cache()
        phase_sweep_resume(torch, Path(sweep_root), export)

    # the experiment catalog (`train/experiments.py`) through
    # run_sweep_synthetic: its kernels at its new shapes first, then three
    # builders over one store; the rows' launches are the N 256 ensembles'
    torch.cuda.empty_cache()
    exp_rows = phase_experiment_kernels(torch, tk, kk)
    torch.cuda.empty_cache()
    launches_at = {}
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_exp_") as exp_root:
        phase_experiments_synthetic(torch, Path(exp_root), launches_at)
    for row in exp_rows:
        sig = "FunctionalTiedSAE" if row["name"] in ("tied_sae_fwd", "tied_sae_bwd_adam") else "TopKEncoderApprox"
        row.update(path="experiments_synthetic", launches=launches_at[sig][row["name"]])
    rows += exp_rows
    # the signatures no builder trains (ROADMAP A8a): graph = eager at full
    # width, card = CPU at a small shape, and the streaming PCA
    torch.cuda.empty_cache()
    phase_signatures(torch, pkg)

    # the subject LM and the activation harvest (ROADMAP A5) at Pythia-70M's
    # width: pretrain, harvest (disk and device, bf16), a killed and resumed
    # harvest, then run_single_layer's sweep on the harvested store
    torch.cuda.empty_cache()
    harvest_rows = phase_harvest_kernels(torch, tk)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_harvest_") as harvest_root:
        harvest_root = Path(harvest_root)
        lm_cfg, lm_params, lang = phase_subject_pretrain(torch, harvest_root)
        torch.cuda.empty_cache()
        folders = phase_harvest(torch, harvest_root, lm_cfg, lm_params, lang)
        phase_harvest_resume(torch, harvest_root, folders)
        harvest_launches, export = phase_harvest_sweep(torch, harvest_root, lm_cfg, lm_params, lang,
                                                       folders[(HARVEST["layer"], "residual")])
        # the paper's evaluation (ROADMAP A8b): perplexity under each dict's
        # reconstruction and the ablation graphs on the pretrained subject,
        # autointerp's device half, the superposition toy grid
        torch.cuda.empty_cache()
        phase_evaluate_lm(torch, lm_cfg, lm_params, lang, export)
        torch.cuda.empty_cache()
        phase_interp_codes(torch, lm_cfg, lm_params, lang, export)
        torch.cuda.empty_cache()
        phase_toy_grid(torch)
        # the remaining single-card paths (ROADMAP A5r, A6a, A8c): the long-context
        # harvest on blockwise attention, the big-batch trainer with
        # resurrection, the paper's experiments' device halves
        torch.cuda.empty_cache()
        phase_blockwise_harvest(torch, harvest_root, lm_cfg, lm_params, lang)
        torch.cuda.empty_cache()
        phase_big_batch(torch, harvest_root, folders[(HARVEST["layer"], "residual")])
        torch.cuda.empty_cache()
        phase_paper_experiments(torch, lm_cfg, lm_params, lang, export, folders[(HARVEST["layer"], "residual")])
        # serving (ROADMAP A7a): the sweep's 16 dicts behind the engine, the
        # HTTP server with the pretrained subject, a SIGTERM drain under load
        torch.cuda.empty_cache()
        rows_pool, serve_tokens = serve_rows_pool(torch, lm_cfg, lm_params, lang)
        phase_serve_encode(torch, export, rows_pool)
        phase_serve_http(torch, export, lm_cfg, lm_params, rows_pool, serve_tokens)
        phase_serve_drain(torch, harvest_root, export, rows_pool, serve_tokens)
        # the replicated tier (ROADMAP A7b): the replicaset CLI's two replica
        # processes behind its router, a SIGKILL and a rolling swap under load
        torch.cuda.empty_cache()
        phase_serve_tier(torch, harvest_root, export, rows_pool)
        keep_run("serve_drain", harvest_root / "serve_events", Path(runs_root.name))
        keep_run("serve_tier", harvest_root / "serve_tier" / "run", Path(runs_root.name))
        # the sequence-parallel harvest (ROADMAP A6b's second part) on the
        # subject: a world of one over NCCL here, then a world of two
        # processes on the one card over gloo
        torch.cuda.empty_cache()
        seqpar_ref = phase_seqpar_world1(torch, harvest_root, lm_cfg, lm_params, lang)
        torch.cuda.empty_cache()
        phase_seqpar_world2(torch, harvest_root, lm_cfg, lm_params, seqpar_ref)
        keep_run("seqpar_world2", harvest_root / "seqpar_run", Path(runs_root.name))
        del lm_params, seqpar_ref
        # the lineage graph over everything the harvest root holds, verified
        # at the digest tier before the root goes (printed by lineage_scrub)
        harvest_lineage = lineage_verify_root(harvest_root)
    for row in harvest_rows:
        row.update(path="harvest_sweep", launches=harvest_launches[row["name"]])
    rows += harvest_rows

    # scale-out (ROADMAP A6b's first part) at BASELINE config 5's widths: a
    # world of one over NCCL, a world of two on the one card over gloo, the
    # preempted sweep resumed as a world of one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_scaleout_") as scale_root:
        rows += phase_scaleout(torch, Path(scale_root))
        keep_run("scaleout_world2", Path(scale_root) / "sweep_full", Path(runs_root.name))
    # the fleet's K_f shape is the data axis' local one (row 9s, timed by the
    # scale-out phase): the same row again with the fleet workers' launches
    fleet_shape = (f"M={len(BLS_L1) // FLEET['groups']},B={BLS['batch']},N={BLS['n_dict']},D={BLS['width']},"
                   f"iters={FISTA_ITERS}")
    fleet_rows = [r for r in rows if r["name"] == "fista_solve" and r["shape"] == fleet_shape]
    check(len(fleet_rows) == 1, f"no K_f row at the fleet's shape {fleet_shape}")
    rows.append(dict(fleet_rows[0], path="fleet", launches=fleet_launches))

    # the run tools (ROADMAP A9's first group) over the run dirs kept above
    phase_runtools(torch, KEPT_RUNS)
    # A9's profiling, lineage and features surfaces: the trace window, the
    # step's cost on the roofline and the transfer audit at config 2; the
    # lineage graph and the scrub on that sweep's tree; the features CLI
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_profiling_") as prof_root:
        profiled = phase_profiling(torch, Path(prof_root))
        phase_lineage_scrub(torch, Path(prof_root), profiled["repair"], harvest_lineage)
    phase_features(torch, KEPT_RUNS["basic_l1_sweep"])
    runs_root.cleanup()

    # the capacity setting's memory: no [M, B, N] code tensor on the tied
    # path, compressed moments on both
    code_bytes = M * B * N * 2
    check(peak["tied_capacity"] <= peak["tied"] - code_bytes,
          f"tied-capacity step peak {peak['tied_capacity']} not {code_bytes} below tied {peak['tied']}")
    check(peak["topk_capacity"] < peak["topk"], f"topk-capacity step peak {peak} not below topk")
    emit("memory", step_peak_bytes=peak, graph_step_peak_bytes=graph_peak, tied_saving=peak["tied"] - peak["tied_capacity"],
         topk_saving=peak["topk"] - peak["topk_capacity"], code_tensor_bytes=code_bytes)

    emit("total", seconds=time.perf_counter() - started)
    for row in rows:
        row["route"] = "cuda"
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "path", "shape", "variant"]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
