"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from `sparse_coding__tpu_torch/ops/csrc`,
holds each against its plain PyTorch version at the main path's shapes and
times it, trains the tied-SAE L1-sweep ensemble (8 members, 512 -> 4096,
batch 2048, Adam lr 1e-3 with bf16 mu, bf16 compute) through
`ensemble_train_loop` over a synthetic chunk store, checks that every kernel
of the path launched, evaluates and exports the dictionaries. Prints one JSON
line per phase, then the `kernels` line, the `nvidia-smi` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and the last line is not printed. Needs a CUDA device; never
falls back to the CPU. Imports nothing of JAX or of `sparse_coding__tpu`.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

M, D, N, B = 8, 512, 4096, 2048
LR = 1e-3
L1_GRID = [10 ** (-4 + 0.25 * i) for i in range(M)]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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
    a, b = a.double().flatten(), b.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-30))
    check(cos > min_cos and rel < max_rel, f"{what}: cos {cos}, max rel {rel}")
    return cos, rel


def parse_ptxas(log: str):
    """Registers, spills and static shared memory per compiled function."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(encode_kernel|decode_kernel|bwd_kernel)", name)
            tmpl = re.search(r"ILb(\d)ELb(\d)E", name)
            label = short.group(1) if short else name
            if tmpl:
                label += f"<adam={tmpl.group(1)},mu_bf16={tmpl.group(2)}>"
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
        ms=time_ms(torch, lambda: tk.tied_sae_fwd(xb, db, bias, scale), 20),
        plain_ms=time_ms(torch, lambda: tk._fwd_plain(xb, db, bias, scale), 5),
        library_ms=time_ms(torch, lambda: torch.bmm(torch.bmm(xbm, dbt), db), 20),
    )
    k1["bound_ms"], k1["bound_by"] = bound(
        2 * 2 * M * B * N * D,
        B * D * 2 + M * N * D * 2 + M * N * 4 + M * B * N * 2 + M * B * D * 2 + 4 * M * 4,
    )
    emit("kernel", name="tied_sae_fwd", c_frac_differ=frac_c, dxh_frac_differ=frac_d,
         max_abs_err_dxh=k1_err, lrec=lrec_k.tolist(), ll1=ll1_k.tolist())
    rows.append(k1)

    l1b = torch.tensor(L1_GRID, device=dev) / B
    bc = torch.tensor([[0.1, 0.001]] * M, device=dev)

    def k2_case(batch, mu_dtype, c, dxh, xb_, d_raw_, nrm_):
        mu = (torch.randn((M, N, D), generator=g, device=dev) * 1e-3).to(mu_dtype)
        nu = torch.rand((M, N, D), generator=g, device=dev) * 1e-6
        args = lambda: (xb_, dxh, c, nrm_, d_raw_.clone(), mu.clone(), nu.clone(), l1b, bc,
                        LR, 0.9, 0.999, 1e-8)
        dk, mk, nk, gbk = tk.tied_sae_bwd_adam(*args())
        dp, mp, np_, gbp = _k2_plain(tk, *args())
        torch.cuda.synchronize()
        dmax = float((dk - dp).abs().max())
        check(dmax <= 2 * LR, f"K2 B={batch} mu={mu_dtype}: |d_new diff| {dmax} > 2 lr")
        grads_close(torch, gbk, gbp, f"K2 B={batch} g_bias")
        grads_close(torch, mk.float(), mp.float(), f"K2 B={batch} mu")
        grads_close(torch, nk, np_, f"K2 B={batch} nu")
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
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_adam(*held), 10),
        plain_ms=time_ms(torch, lambda: _k2_plain(tk, *args()), 3),
        library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k),
                                           torch.bmm(ct, xbt)), 10),
    )
    k2["bound_ms"], k2["bound_by"] = bound(
        3 * 2 * M * B * N * D,
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
        replaces="sparse_coding__tpu/ops/tied_sae_kernel.py:201", max_abs_err=k3_err,
        ms=time_ms(torch, lambda: tk.tied_sae_bwd_grads(xb, dxh_k, c_k, nrm, db, l1b), 10),
        plain_ms=time_ms(torch, lambda: tk._grads_plain(xb, dxh_k, c_k, nrm, db, l1b), 3),
        library_ms=time_ms(torch, lambda: (torch.bmm(dxh_k, dbt), torch.bmm(ct, dxh_k),
                                           torch.bmm(ct, xbt)), 10),
    )
    k3["bound_ms"], k3["bound_by"] = bound(
        3 * 2 * M * B * N * D,
        B * D * 2 + M * B * D * 2 + M * B * N * 2 + M * N * 4 + M * N * D * 2
        + M * N * D * 4 + M * N * 4 + M * 4,
    )
    rows.append(k3)
    return rows


def _k2_plain(tk, xb, dxh, c, nrm, d_raw, mu, nu, l1b, bc, lr, b1, b2, eps):
    """K2's plain version on CUDA tensors (the wrapper sends CUDA to the kernel)."""
    import torch

    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, g_bias = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    return (*tk._adam_plain(gr, d_raw, mu, nu, bc, lr, b1, b2, eps), g_bias)


def phase_train(torch, pkg):
    """The main path: chunk store → ensemble_train_loop → masked step."""
    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
    from sparse_coding__tpu_torch.utils import precision as px

    sig = pkg.FunctionalTiedSAE
    tmp = tempfile.TemporaryDirectory(prefix="sc_chip_smoke_")
    root = Path(tmp.name)
    gen = RandomDatasetGenerator(
        activation_dim=D, n_ground_truth_components=1024, batch_size=4096,
        feature_num_nonzero=8, feature_prob_decay=0.996, correlated=False, key=0,
    )
    rows_per_chunk = 65536
    store = generate_synthetic_chunks(gen, root / "store", 2, chunk_size_gb=rows_per_chunk * D * 2 / 1024**3)
    check(store.indices() == [0, 1], f"store indices {store.indices()}")
    eval_batch = torch.cat([next(gen) for _ in range(2)])

    ens = pkg.build_ensemble(
        sig, 0, [{"l1_alpha": a} for a in L1_GRID],
        optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
        compute_dtype="bfloat16", activation_size=D, n_dict_components=N,
    )
    check(ens.fused and ens.fused_adam is not None, f"fused {ens.fused}, fused_adam {ens.fused_adam}")

    def eval_loss():
        st = ens.state
        with torch.no_grad(), px.compute(torch.bfloat16):
            total, _ = sig.loss(st.params, st.buffers, eval_batch[:B])
        return total

    loss0 = eval_loss()
    tk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, last = 0, None
    for i, chunk in enumerate(store.iter_chunks([0, 1])):
        last = ensemble_train_loop(ens, chunk, B, key=i)
        steps += chunk.shape[0] // B
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one masked step: the fused-Adam kernel gives way to fused grads (K3)
    frozen = ens.state.params["encoder"][M - 1].clone()
    ens.set_update_mask([1.0] * (M - 1) + [0.0])
    masked_loss, _ = ens.step_batch(eval_batch[B:2 * B])
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    check(launches["tied_sae_bwd_adam"] == steps, f"K2 launches {launches} != {steps} steps")
    check(launches["tied_sae_fwd"] == steps + 1, f"K1 launches {launches} != {steps} + 1")
    check(launches["tied_sae_bwd_grads"] == 1, f"K3 launches {launches} != 1")
    check(torch.equal(frozen, ens.state.params["encoder"][M - 1]), "masked member moved")
    loss1 = eval_loss()
    finite = all(bool(torch.isfinite(v).all()) for v in (*last.values(), *masked_loss.values(), loss1))
    check(finite, "non-finite loss")
    check(float(loss1.mean()) < float(loss0.mean()), f"mean loss did not fall: {loss0} -> {loss1}")
    emit(
        "train", steps=steps, batch=B, members=M, wall_s=wall,
        activations_per_s=steps * B * M / wall, loss_before=loss0.tolist(),
        loss_after=loss1.tolist(), last_step_loss=last["loss"].tolist(), launches=launches,
    )
    return ens, gen, eval_batch, tmp, launches


def phase_step_time(torch, pkg):
    """The fused-Adam step on a batch already on the card: CUDA-event time
    per step beside the host's time to enqueue it (enqueue << step means the
    card, not the host, sets the pace)."""
    ens = pkg.build_ensemble(
        pkg.FunctionalTiedSAE, 1, [{"l1_alpha": a} for a in L1_GRID],
        optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
        compute_dtype="bfloat16", activation_size=D, n_dict_components=N,
    )
    x = torch.randn((B, D), device="cuda")
    for _ in range(3):
        ens.step_batch(x)
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        ens.step_batch(x)
    end.record()
    enqueue = time.perf_counter() - t0
    end.synchronize()
    wall = time.perf_counter() - t0
    emit("step", steps=reps, ms_per_step=start.elapsed_time(end) / reps,
         host_enqueue_ms_per_step=enqueue * 1e3 / reps, wall_ms_per_step=wall * 1e3 / reps,
         activations_per_s=reps * B * M / wall)


def phase_small_parity(torch, pkg):
    """A few fused steps at a small shape on the card and on the CPU (the
    plain versions) from the same state must agree."""
    sig = pkg.FunctionalTiedSAE
    kw = dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
              compute_dtype="bfloat16", activation_size=128, n_dict_components=512)
    ens_c = pkg.build_ensemble(sig, 3, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], device="cpu", **kw)
    ens_g = pkg.build_ensemble(sig, 3, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], device="cpu", **kw)
    ens_g = pkg.Ensemble.from_state(ens_g.state_dict(), device="cuda")
    x = torch.randn((3, 256, 128), generator=torch.Generator().manual_seed(5))
    worst_loss, worst_param = 0.0, 0.0
    for k in range(3):
        lc, _ = ens_c.step_batch(x[k])
        lg, _ = ens_g.step_batch(x[k].cuda())
        worst_loss = max(worst_loss, float(((lg["loss"].cpu() - lc["loss"]) / lc["loss"]).abs().max()))
        dp = float((ens_g.state.params["encoder"].cpu() - ens_c.state.params["encoder"]).abs().max())
        worst_param = max(worst_param, dp)
        check(worst_loss < 1e-3, f"small parity: loss rel {worst_loss}")
        check(dp <= 2 * LR * (k + 1), f"small parity: encoder diff {dp} after {k + 1} steps")
    emit("small_parity", steps=3, max_loss_rel=worst_loss, max_encoder_diff=worst_param)


def phase_eval_export(torch, ens, gen, eval_batch, tmp):
    from sparse_coding__tpu_torch.metrics.standard import evaluate_dicts, mmcs_to_fixed
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    lds = ens.to_learned_dicts()
    metrics = evaluate_dicts(lds, eval_batch)
    mmcs = [float(mmcs_to_fixed(ld, gen.feats)) for ld in lds]
    for row in metrics:
        check(math.isfinite(row["fvu"]) and math.isfinite(row["l0"]), f"metrics {row}")
    path = Path(tmp.name) / "learned_dicts.pkl"
    save_learned_dicts(path, [(ld, {"l1_alpha": a}) for ld, a in zip(lds, L1_GRID)])
    loaded = load_learned_dicts(path, verify=True)
    check(len(loaded) == M, "export lost members")
    for ld, (ld2, _) in zip(lds, loaded):
        check(torch.equal(ld.encode(eval_batch[:256]), ld2.encode(eval_batch[:256])), "codes differ after export")
    emit("eval_export", fvu=[r["fvu"] for r in metrics], l0=[r["l0"] for r in metrics], mmcs=mmcs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import sparse_coding__tpu_torch as pkg
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

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
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: parse_ptxas(v) for k, v in _build.ptxas_log().items()})

    rows = phase_kernels(torch, tk)
    torch.cuda.empty_cache()
    phase_small_parity(torch, pkg)
    phase_step_time(torch, pkg)
    torch.cuda.empty_cache()
    ens, gen, eval_batch, tmp, launches = phase_train(torch, pkg)
    phase_eval_export(torch, ens, gen, eval_batch, tmp)
    tmp.cleanup()

    for row in rows:
        row["route"] = "cuda"
        row["launches"] = launches[row["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
