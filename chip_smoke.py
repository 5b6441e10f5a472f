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
snapshots the uninterrupted run's bits. Then the sweep driver
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
`topk_experiment`) and the default builder in exact f32, each ensemble's
launches counted and none outside the train loops, the export, the
evaluation, the matched MCS and the streaming moments checked.
Launch counts are the wrappers' (`ops/_wrap.py::LaunchCounts`, kept on the
card, so graph replays count), each set to 0 just before a run and read
just after; a profiler trace of the run may not count more, and a trace
that counts fewer is printed as ``trace_short``. Prints one JSON line per
phase, then the `kernels` line, the `nvidia-smi` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. Needs a CUDA device; never
falls back to the CPU. Imports nothing of JAX or of `sparse_coding__tpu`.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import shutil
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
# (`TopKEncoderApprox`)
EXPERIMENTS = dict(builders=(("synthetic_linear_range", "bfloat16"), ("tied_vs_not_experiment", "bfloat16"),
                             ("topk_experiment", "bfloat16"), ("synthetic_linear_range", "float32")),
                   width=512, batch=1024, chunks=2, rows_per_chunk=65536, epochs=1, topk_recall=0.95,
                   eval_rows=4096)
# the new shapes the catalog gives the kernels (M, B, N, D): a tied
# `synthetic_linear_range` stack at ratio 0.5, a TopK stack at ratio 0.5 with
# k 1..151 (cap 151 of N 256: the code ~59% dense)
EXP_TIED = (32, 1024, 256, 512)
EXP_TOPK = (16, 1024, 256, 512)
EXP_KS = list(range(1, 161, 10))
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
    needs."""
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
    k1["bound_ms"], k1["bound_by"] = bound(
        2 * M * B * N * D + 2 * nnz * D,
        B * D * 2 + M * N * D * 2 + M * N * 4 + M * B * N * 2 + M * B * D * 2 + 4 * M * 4,
    )
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
    k2["bound_ms"], k2["bound_by"] = bound(
        6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4
        + 2 * (M * N * D * (4 + 2 + 4)) + M * N * 4 + 3 * M * 4,
    )
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
    k3["bound_ms"], k3["bound_by"] = bound(
        6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4 + M * N * D * 2
        + M * N * D * 4 + M * N * 4 + M * 4,
    )
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
    k1n["bound_ms"], k1n["bound_by"] = bound(
        2 * M * B * N * D + 2 * nnz * D,
        B * D * 2 + M * N * D * 2 + M * N * 4 + M * B * D * 2 + 2 * M * (B // 64) * 4,
    )
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
    k2["bound_ms"], k2["bound_by"] = bound(
        2 * M * B * N * D + 6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * N * 4 + M * N * 4 + M * N * 4
        + 2 * (M * N * D * (4 + 1 + 2) + M * N * 4) + M * 4 + 2 * M * 4 + 4,
    )
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
    t0 = time.perf_counter()
    start.record()
    losses = ens.step_scan(xs)
    end.record()
    enqueue_g = time.perf_counter() - t0
    end.synchronize()
    wall_g = time.perf_counter() - t0
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
    row["bound_ms"], row["bound_by"] = bound(
        6 * nnz * TD,
        TB * TD * 2 + TM * TB * TD * 2 + TM * TB * TN * 2 + TM * TN * 4
        + 2 * (TM * TN * TD * (4 + 4 + 4)) + TM * TN * 4 + 3 * TM * 4,
    )
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
    row["bound_ms"], row["bound_by"] = bound(
        6 * nnz * TD,
        TB * TD * 2 + TM * TB * TD * 2 + TM * TB * TN * 2 + TM * TN * 4
        + 2 * (TM * TN * TD * (4 + 1 + 2) + TM * TN * 4) + TM * TN * 4 + 3 * TM * 4 + 4,
    )
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
    row["bound_ms"], row["bound_by"] = bound(
        6 * nnz * TD,
        TB * TD * 2 + TM * TB * TD * 2 + TM * TB * TN * 2 + TM * TN * 4 + TM * TN * TD * 2
        + TM * TN * TD * 4 + TM * TN * 4 + TM * 4,
    )
    rows.append(row)
    # the two routes side by side at this shape (the dense route's own rows
    # are the tied paths', where it runs)
    emit("kernel", name="tied_sae_bwd routes", shape=shape, code_nonzero_frac=nnz / c_k.numel(),
         sparse_ms=sparse_ms, dense_ms=dense_ms, library_ms=library_ms)
    return rows, capacity_rows


def phase_experiment_kernels(torch, tk, kk):
    """K1/K2 and K_s/K_d/the sparse K2 at the shapes the experiment catalog
    gives them (`EXP_TIED`, `EXP_TOPK`), against their plain versions with
    the tolerances of the main paths' checks, timed. Adam's moments are f32
    here (the builders' plain ``"adam"``). Returns the kernels-line rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    rows = []

    def inputs(M, B, N, D):
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(torch.bfloat16)
        xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
        return d_raw, nrm, db, xb

    # tied: K1, then K2 on its code
    M, B, N, D = EXP_TIED
    shape = f"M={M},B={B},N={N},D={D}"
    d_raw, nrm, db, xb = inputs(M, B, N, D)
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
              variant="pipelined encode -> decode (TMA, wgmma), code stored",
              ms=time_ms(torch, lambda: tk.tied_sae_fwd(xb, db, bias, scale), 20),
              plain_ms=time_ms(torch, lambda: tk._fwd_plain(xb, db, bias, scale), 5),
              library_ms=time_ms(torch, lambda: torch.bmm(torch.bmm(xbm, dbt), db), 20))
    k1["bound_ms"], k1["bound_by"] = bound(
        2 * M * B * N * D + 2 * nnz * D,
        B * D * 2 + M * N * D * 2 + M * N * 4 + M * B * N * 2 + M * B * D * 2 + 4 * M * 4)
    emit("kernel", name="tied_sae_fwd", shape=shape, c_frac_differ=frac_c, dxh_frac_differ=frac_d,
         c_nonzero_frac=nnz / c_k.numel(), ms=k1["ms"], bound_ms=k1["bound_ms"], plain_ms=k1["plain_ms"])
    rows.append(k1)
    del c_p, dxh_p
    l1b = torch.logspace(-4, -2, M, device=dev) / B
    args, k2_err = check_k2(torch, tk, g, torch.float32, (xb, dxh_k, c_k, nrm), d_raw, l1b, f"{shape} mu=f32")
    held = args()
    ct, xbt = c_k.transpose(1, 2), xb.expand(M, B, D)
    k2 = dict(name="tied_sae_bwd_adam", source="sparse_coding__tpu_torch/ops/csrc/tied_sae_bwd.cu",
              replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:255", shape=shape, max_abs_err=k2_err,
              variant="stored code, mu f32, nu f32",
              ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held), 10),
              plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3),
              library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k), torch.bmm(ct, xbt)), 10))
    k2["bound_ms"], k2["bound_by"] = bound(
        6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4 + 2 * (M * N * D * (4 + 4 + 4)) + M * N * 4 + 3 * M * 4)
    emit("kernel", name="tied_sae_bwd_adam", shape=shape, max_abs_err_d_new=k2_err, ms=k2["ms"],
         bound_ms=k2["bound_ms"], plain_ms=k2["plain_ms"])
    rows.append(k2)
    del held, d_raw, nrm, db, xb, bias, c_k, dxh_k

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
    k2s["bound_ms"], k2s["bound_by"] = bound(
        6 * nnz * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4 + 2 * (M * N * D * (4 + 4 + 4)) + M * N * 4 + 3 * M * 4)
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
    src = "sparse_coding__tpu_torch/ops/csrc/fista.cu"
    rows = []
    for shape, line, seed, atol, reps, l1_grid in (
        (FISTA_ROW8, 54, 11, 1e-4, 10, FISTA_L1),
        (dict(M=FM, B=FB, N=FN, D=FD, iters=FISTA_ITERS), 133, 12, 1e-3, 2, FISTA_L1),
        (dict(M=BLS["members"], B=BLS["batch"], N=BLS["n_dict"], D=BLS["width"], iters=FISTA_ITERS), 133, 15, 1e-3,
         2, BLS_L1),
    ):
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
        rows.append(row)
        del x, d, c0, a_k
        torch.cuda.empty_cache()

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
    builds it and saves its ground truth), three in bf16 compute and the
    default builder in exact f32. Launches: every count set to 0 just before
    a run and read just after, and around each of its train loop calls set
    to 0 on entry and read on exit, so each ensemble's launches are its
    loops' and no kernel may launch outside the loops. K1 = K2 = steps on
    each bf16 tied ensemble, none of the hand-written kernels on the untied
    and the f32 ones, K_s = K_d = the sparse K2 = steps on each TopK
    ensemble. The export reloads in the port equal to what the sweep
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
    from sparse_coding__tpu_torch.models.learned_dict import LEARNED_DICT_REGISTRY
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
    fused = {"FunctionalTiedSAE": ("tied_sae_fwd", "tied_sae_bwd_adam"), "FunctionalSAE": (),
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
            kernels = fused[sig] if dtype == "bfloat16" else ()
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
            for f in LEARNED_DICT_REGISTRY[type(a)][0]:
                check(torch.equal(getattr(a, f), getattr(b, f)), f"{name}: exported {f} differs")
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
    sys.path.insert(0, str(REPO / "tests"))  # _torch_moments, _torch_trace: helpers the CUDA tests share
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

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
        torch.cuda.empty_cache()
        phase_basic_l1_sweep_resume(torch, Path(bls_root), control)
    bls_row = dict(fista_rows[2], path="basic_l1_sweep", launches=bls_launches)
    rows.append(bls_row)

    # the sweep driver (BASELINE config 2's widths): K1 + K2 and K1 + K3,
    # then a preempted and resumed run held to the uninterrupted one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sc_chip_smoke_sweep_") as sweep_root:
        export = phase_sweep_train(torch, Path(sweep_root))
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

    # the capacity setting's memory: no [M, B, N] code tensor on the tied
    # path, compressed moments on both
    code_bytes = M * B * N * 2
    check(peak["tied_capacity"] <= peak["tied"] - code_bytes,
          f"tied-capacity step peak {peak['tied_capacity']} not {code_bytes} below tied {peak['tied']}")
    check(peak["topk_capacity"] < peak["topk"], f"topk-capacity step peak {peak} not below topk")
    emit("memory", step_peak_bytes=peak, graph_step_peak_bytes=graph_peak, tied_saving=peak["tied"] - peak["tied_capacity"],
         topk_saving=peak["topk"] - peak["topk_capacity"], code_tensor_bytes=code_bytes)

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
