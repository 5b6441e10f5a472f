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
step of each with its peak device memory. Prints one JSON line per
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
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
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:191", max_abs_err=k1_err, variant="code stored",
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
         ll1=ll1_k.tolist())
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
    torch.cuda.synchronize()
    check(torch.equal(dxh_n.view(torch.int16), dxh_k.view(torch.int16)), "K1n dxh differs from K1's")
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
    summary = dict(k1n_dxh_bit_equal_k1=True, k1n_lrec_rel_vs_k1=lrec_rel, k1n_ll1_rel_vs_k1=ll1_rel,
                   k1n_dxh_frac_differ_plain=frac_d)
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
    step. Every step of the loop launches the path's forward kernels and K2
    on the path's route (dense for tied, sparse for TopK); the masked step
    launches the masked forward kernels and K3 on that route; nothing else
    runs."""
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk
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

    loss0 = eval_loss()
    tk.reset_launches()
    kk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, last = 0, None
    for i, chunk in enumerate(store.iter_chunks([0, 1])):
        last = ensemble_train_loop(ens, chunk, batch, key=i)
        steps += chunk.shape[0] // batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_launches = {**tk.LAUNCHES, **kk.LAUNCHES}
    want = {name: 0 for name in loop_launches}
    want.update({name: steps for name in (*cfg["fwd_kernels"], cfg["bwd_adam"])})
    check(loop_launches == want, f"launches {loop_launches} after {steps} steps, want {want}")
    # one masked step: the fused-Adam kernel gives way to fused grads (K3)
    frozen = ens.state.params[leaf][members - 1].clone()
    ens.set_update_mask([1.0] * (members - 1) + [0.0])
    masked_loss, _ = ens.step_batch(eval_batch[batch:2 * batch])
    torch.cuda.synchronize()
    launches = {**tk.LAUNCHES, **kk.LAUNCHES}
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
        launches_after_loop=loop_launches, launches=launches,
    )
    return ens, gen, eval_batch, tmp, launches


def phase_step_time(torch, pkg, cfg, reps: int = 20):
    """The fused-Adam step on a batch already on the card: CUDA-event time
    per step beside the host's time to enqueue it (enqueue << step means the
    card, not the host, sets the pace), and the peak device memory of a step
    with the ensemble's state resident (`max_memory_allocated` over the
    steps, less what was allocated before the ensemble was built). Returns
    that peak in bytes."""
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
    return peak


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
    # the kernel's own scores gives the same threshold bits
    s_k, th_k = kk.topk_scores(xb, db, k)
    s_p, _ = kk._topk_scores_plain(xb, db, k)
    th_p = kk._select_plain(s_k, k)
    torch.cuda.synchronize()
    frac_s, ulp_s = bf16_close(torch, s_k, s_p)
    check(ulp_s and frac_s < 1e-3, f"K_s s: {frac_s} differ, within 1 ulp: {ulp_s}")
    check(torch.equal(th_k.view(torch.int32), th_p.view(torch.int32)),
          "K_s thresholds differ from the plain select on the kernel's scores")
    ks_err = float((s_k.float() - s_p.float()).abs().max())
    del s_p, th_p
    xbm = xb.expand(TM, TB, TD)
    dbt = db.transpose(1, 2)
    row = dict(
        name="topk_scores", source=src, replaces="sparse_coding__tpu/ops/topk_kernel.py:98",
        max_abs_err=ks_err, shape=shape, variant="scores + exact select",
        ms=time_ms(torch, lambda: kk.topk_scores(xb, db, k), 10),
        plain_ms=time_ms(torch, lambda: kk._topk_scores_plain(xb, db, k), 3),
        library_ms=time_ms(torch, lambda: torch.topk(torch.bmm(xbm, dbt), max(TOPK_KS), dim=-1), 10),
    )
    row["bound_ms"], row["bound_by"] = bound(
        2 * TM * TB * TN * TD,
        TB * TD * 2 + TM * TN * TD * 2 + TM * 4 + TM * TB * TN * 2 + TM * TB * 4,
    )
    emit("kernel", name="topk_scores", s_frac_differ=frac_s, max_abs_err_s=ks_err,
         thresholds_bit_equal=True)
    rows.append(row)

    # K_d on the kernel's own scores and thresholds: c bit-equal, dxh within
    # 1 ulp, the loss sum within 1e-3
    c_k, dxh_k, lrec_k = kk.topk_decode(s_k, th_k, db, xb, scale)
    c_p, dxh_p, lrec_p = kk._topk_decode_plain(s_k, th_k, db, xb, scale)
    torch.cuda.synchronize()
    check(torch.equal(c_k.view(torch.int16), c_p.view(torch.int16)), "K_d c differs from the plain version")
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
        max_abs_err=kd_err, shape=shape, variant="masked decode",
        ms=time_ms(torch, lambda: kk.topk_decode(s_k, th_k, db, xb, scale), 10),
        plain_ms=time_ms(torch, lambda: kk._topk_decode_plain(s_k, th_k, db, xb, scale), 3),
        library_ms=time_ms(torch, lambda: torch.bmm(c_k, db), 10),
    )
    row["bound_ms"], row["bound_by"] = bound(
        2 * nnz * TD,
        2 * TM * TB * TN * 2 + TM * TB * 4 + TM * TN * TD * 2 + TB * TD * 2 + TM * TB * TD * 2 + TM * 4,
    )
    emit("kernel", name="topk_decode", c_bit_equal=True, dxh_frac_differ=frac_d, max_abs_err_dxh=kd_err,
         lrec_max_rel=rel, c_nonzero_frac=nnz / c_k.numel(), mean_l0=l0.tolist(), k=TOPK_KS)
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
    and at BASELINE config 3, where it picks `_fista_kernel_hbm_dict` (M 4,
    B 2048, N 2048, D 512, 500 iterations); each timed beside the plain loop
    and the library yardstick (the same 2·iterations f32 `bmm` calls without
    the epilogues, which the port never calls), and bounded by the work the
    data needs: x − ŷ·D over the non-zeros of ŷ that the plain loop met in
    its iterations (`watching_plain_solves`), res·Dᵀ dense. Tolerances: codes within
    1e-4 at 100 iterations (the JAX suite's pin for `_fista_kernel`) and 1e-3
    at config 3's 500 (should the two sum their 2048 and 512 products in
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
    for shape, line, seed, atol, reps in (
        (FISTA_ROW8, 54, 11, 1e-4, 10),
        (dict(M=FM, B=FB, N=FN, D=FD, iters=FISTA_ITERS), 133, 12, 1e-3, 2),
    ):
        M, B, N, D, iters = shape["M"], shape["B"], shape["N"], shape["D"], shape["iters"]
        check(fk.shapes_supported(B, N, D), f"K_f does not take {shape}")
        x, d, c0, l1 = fista_problem(torch, M, B, N, D, seed)
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
            max_abs_err=diff, shape=label, variant="f32 FMA GEMM tiles, 2 launches an iteration",
            ms=time_ms(torch, lambda: fk.fista_cuda(x, d, eta, l1, c0, iters), reps, warmup=1),
            plain_ms=time_ms(torch, lambda: tf.fista_codes(x, d, eta, l1, c0, iters), reps, warmup=1),
            library_ms=time_ms(torch, library, reps, warmup=1),
        )
        # every iteration ran for every member (tol = 0): x − ŷ·D needs 2·D
        # operations per non-zero of ŷ (counted over this run's iterations),
        # res·Dᵀ 2·B·N·D; x, D and c0 read once, the codes written once
        row["bound_ms"], row["bound_by"] = bound(
            2 * D * yhat_nnz + 2 * B * N * D * iters * M, 4 * (B * D + M * N * D + 2 * M * B * N + 2 * M),
            PEAK_F32_FLOPS,
        )
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))  # _torch_moments: the moment helpers the CUDA tests share
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.models import fista as tf
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import fista_kernel as fk
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.ops import topk_kernel as kk

    # plain versions and references in exact f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        ens, gen, eval_batch, tmp, launches = phase_train(torch, pkg, cfg)
        phase_eval_export(torch, cfg, ens, gen, eval_batch, tmp)
        tmp.cleanup()
        del ens, gen, eval_batch
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
    peak = {"tied": phase_step_time(torch, pkg, TIED)}
    rows = label(rows, TIED, drive(TIED), tied_shape)

    # the same at the capacity setting: K1n + K2 rebuilding the code
    capacity_rows = phase_capacity_kernels(torch, tk)
    torch.cuda.empty_cache()
    phase_small_parity(torch, pkg, pkg.FunctionalTiedSAE, optimizer_kwargs=CAPACITY_ADAM,
                       env=TIED_CAPACITY["env"], **small_tied)
    peak["tied_capacity"] = phase_step_time(torch, pkg, TIED_CAPACITY)
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
    peak["topk"] = phase_step_time(torch, pkg, TOPK, reps=10)
    rows += label(topk_capacity_rows, TOPK_CAPACITY, drive(TOPK_CAPACITY))
    peak["topk_capacity"] = phase_step_time(torch, pkg, TOPK_CAPACITY, reps=10)

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
    rows += label(fista_rows, FISTA, launches)

    # the capacity setting's memory: no [M, B, N] code tensor on the tied
    # path, compressed moments on both
    code_bytes = M * B * N * 2
    check(peak["tied_capacity"] <= peak["tied"] - code_bytes,
          f"tied-capacity step peak {peak['tied_capacity']} not {code_bytes} below tied {peak['tied']}")
    check(peak["topk_capacity"] < peak["topk"], f"topk-capacity step peak {peak} not below topk")
    emit("memory", step_peak_bytes=peak, tied_saving=peak["tied"] - peak["tied_capacity"],
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
