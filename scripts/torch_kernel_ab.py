"""Time the PyTorch port's default paths of two checkouts on one card, in
turns (A, B, B, A): their CUDA kernels in one process, then their whole
resident training steps.

    python scripts/torch_kernel_ab.py --a PARENT_DIR [--b .] [--reps 20] [--step-reps 30] [--kernels-only]
                                      [--configs 2,3,4,5]

Kernels: each checkout's `sparse_coding__tpu_torch/ops/csrc/{tied_sae_fwd,
tied_sae_bwd,tied_sae_bwd_rc,tied_sae_bwd_sparse,topk_fwd,fista}.cu` is compiled with this checkout's
nvcc flags (one nvcc per source, all at once) into `build/kernel_ab/<a|b>/`,
loaded with ctypes and called through its C entries (`sc_tied_sae_fwd`,
`sc_tied_sae_fwd_nocode`, `sc_tied_sae_bwd_grads`, `sc_topk_scores`,
`sc_topk_decode`, and K2 through
`sc_tied_sae_bwd_adam_tiers`, or `sc_tied_sae_bwd_adam` in a checkout from
before the moment tiers) on the same inputs at the main paths' shapes: the
tied SAE of BASELINE config 2 (M 8, B 2048, N 4096, D 512; K1 and K1n; K2 with bf16 mu
on the stored code, and with int8 mu and bf16 nu rebuilding the code, the
tied-capacity path's) and the TopK sweep of config 4 (M 7, B 2048, N 12288,
D 768, k 1..151; K2 with f32 mu on the dense route, and on the sparse route
that the TopK paths take: K2 with f32 moments, K2 with int8 mu and bf16 nu,
K3, through `sc_tied_sae_bwd_adam_sparse` and `sc_tied_sae_bwd_grads_sparse`
where the checkout has them); and K_f (`sc_fista_solve`, with the grid
barrier's count where the checkout's entry takes one) at BASELINE config 3
cut to ``--fista-iters`` iterations and at row 8's shape (the dictionary's
transpose passed too where the entry takes it); and with ``--configs``
naming 5, BASELINE config 5 (M 4, B 2048, N 32768, D 1024): K1, K1n, K2 on
the stored code with f32 moments and K2 rebuilding the code with int8 mu
and bf16 nu (the capacity tiers). ``--configs`` (default 2,3,4) picks the
kernel cases by configuration (row 8's K_f goes with config 3). K1's
outputs are compared on c and dxh: its loss partials changed layout in the
checkouts that moved K1 onto K1n's pipeline (D 512, then D 1024).

Steps: one child process per turn imports a checkout's package, builds the
chip_smoke.py ensemble of a path (`TIED`, `TIED_CAPACITY`, `TOPK`,
`TOPK_CAPACITY`, `FISTA`), takes 3 steps on one batch resident on the card
(the FISTA step: the gradient step, then the 500-iteration decoder update),
then times ``--step-reps`` more (3 for FISTA): CUDA-event ms per step, the host's time to
enqueue one, the peak device memory over the timed steps above what was
allocated before the ensemble, and a digest of the params after them
(skipped with ``--kernels-only``).

Prints one JSON object: per kernel and per path the numbers of each turn,
whether the two checkouts' outputs (K_s: s and the thresholds; a path: its
params after the timed steps of each checkout's first turn) are bit-equal
and the fraction of each output's elements that differ, with the card's
name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("tied_sae_fwd", "tied_sae_bwd", "tied_sae_bwd_rc", "tied_sae_bwd_sparse", "topk_fwd", "fista")
# K2's C entry before the moment tiers: (x, dxh, c, nrm, d_raw, mu, mu_bf16,
# nu, g_bias, l1_over_b, bc, lr, b1, b2, eps, omb1, omb2, M, B, N, D, stream)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_K2 = {"sc_tied_sae_bwd_adam": [_P] * 6 + [_I, _P, _P, _P, _P] + [_F] * 6 + [_I] * 4 + [_P]}
# K_f's C entry before its one-launch design (no grid barrier count)
HOST_PACED_K_F = {"sc_fista_solve": [_P] * 10 + [_I] * 5 + [_P]}


def build(tree: Path, out: Path, flags, nvcc: str):
    """Compile the tree's default-path sources in parallel; {stem: CDLL}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in SOURCES:
        src = tree / "sparse_coding__tpu_torch" / "ops" / "csrc" / f"{stem}.cu"
        if not src.is_file():  # a checkout from before the source
            continue
        procs[stem] = subprocess.Popen([nvcc, *flags, "-o", str(out / f"lib{stem}.so"), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for stem, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {tree}/{stem}.cu:\n{log}")
    return {stem: ctypes.CDLL(str(out / f"lib{stem}.so")) for stem in procs}


def bind(libs, signatures):
    for lib in libs.values():
        for name, argtypes in signatures.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("--b", default=str(REPO), help="checkout B (default: this one)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--step-reps", type=int, default=30)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, not the steps")
    ap.add_argument("--fista-iters", type=int, default=50, help="K_f's iterations at config 3")
    ap.add_argument("--configs", default="2,3,4", help="the kernel cases' configurations (comma list of 2, 3, 4, 5)")
    ap.add_argument("--child-tree", help=argparse.SUPPRESS)
    ap.add_argument("--child-path", help=argparse.SUPPRESS)
    ap.add_argument("--child-save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child_tree:
        return child(Path(args.child_tree).resolve(), args.child_path, args.step_reps, args.child_save)
    if not args.a:
        ap.error("--a is required")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from sparse_coding__tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc = _build._nvcc()
    trees = {"a": Path(args.a).resolve(), "b": Path(args.b).resolve()}
    libs = {k: build(t, REPO / "build" / "kernel_ab" / k, _build.NVCC_FLAGS, nvcc) for k, t in trees.items()}
    one_launch_k_f = {}
    for k, v in libs.items():
        one_launch_k_f[k] = "dict_t" in (trees[k] / "sparse_coding__tpu_torch/ops/csrc/fista.cu").read_text()
        bind(v, {**_build.SIGNATURES, **FIRST_K2, **({} if one_launch_k_f[k] else HOST_PACED_K_F)})

    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(99)
    bf16 = torch.bfloat16

    def tied(M, B, N, D):
        d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
        bias = torch.randn((M, N), generator=g, device=dev) * 0.01
        xb = torch.randn((B, D), generator=g, device=dev).to(bf16)
        nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
        db = (d_raw / nrm[..., None]).to(bf16)
        return d_raw, bias, xb, nrm, db

    cases = {}
    # tied SAE, config 2
    M, B, N, D = 8, 2048, 4096, 512
    d_raw, bias, xb, nrm, db = tied(M, B, N, D)
    scale = 2.0 / (B * D)
    c = torch.empty((M, B, N), dtype=bf16, device=dev)
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    l1p = torch.empty((M, B // 64, N // 128), device=dev)
    lrp = torch.empty((M, B // 64, D // 128), device=dev)
    libs["b"]["tied_sae_fwd"].sc_tied_sae_fwd(xb.data_ptr(), db.data_ptr(), bias.data_ptr(), c.data_ptr(),
                                              dxh.data_ptr(), l1p.data_ptr(), lrp.data_ptr(), M, B, N, D, scale, st)
    l1b = torch.linspace(1e-4, 1e-2, M, device=dev) / B
    bc = torch.tensor([[0.1, 0.001]] * M, device=dev)
    mu = (torch.randn((M, N, D), generator=g, device=dev) * 1e-3).to(bf16)
    nu = torch.rand((M, N, D), generator=g, device=dev) * 1e-6

    def k1(lib):
        outs = (torch.empty_like(c), torch.empty_like(dxh), torch.empty_like(l1p), torch.empty_like(lrp))
        return lambda: (lib["tied_sae_fwd"].sc_tied_sae_fwd(
            xb.data_ptr(), db.data_ptr(), bias.data_ptr(), *(o.data_ptr() for o in outs), M, B, N, D, scale, st),
            outs)[1][:2]

    def k1n(lib):
        outs = (torch.empty_like(dxh), torch.empty((2, M, B // 64), device=dev))
        return lambda: (lib["tied_sae_fwd"].sc_tied_sae_fwd_nocode(
            xb.data_ptr(), db.data_ptr(), bias.data_ptr(), outs[0].data_ptr(), outs[1][0].data_ptr(),
            outs[1][1].data_ptr(), M, B, N, D, scale, st), outs)[1]

    seed = torch.ones(1, dtype=torch.int32, device=dev)

    def k2(lib, d_raw=d_raw, mu=mu, nu=nu, xb=xb, dxh=dxh, c=c, nrm=nrm, l1b=l1b, bc=bc, shape=(M, B, N, D)):
        held = (d_raw.clone(), mu.clone(), nu.clone(), torch.empty(shape[0], shape[2], device=dev))
        bwd, mu_t = lib["tied_sae_bwd"], int(mu.dtype == bf16)
        hp = (1e-3, 0.9, 0.999, 1e-8, 1 - 0.9, 1 - 0.999)

        def run():
            d, m_, n_, gb = held
            if hasattr(bwd, "sc_tied_sae_bwd_adam"):  # a checkout from before the moment tiers
                bwd.sc_tied_sae_bwd_adam(
                    xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), d.data_ptr(), m_.data_ptr(),
                    mu_t, n_.data_ptr(), gb.data_ptr(), l1b.data_ptr(), bc.data_ptr(), *hp, *shape, st)
            else:
                bwd.sc_tied_sae_bwd_adam_tiers(
                    xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), d.data_ptr(), m_.data_ptr(),
                    None, mu_t, n_.data_ptr(), None, 0, gb.data_ptr(), l1b.data_ptr(), bc.data_ptr(),
                    seed.data_ptr(), 256, *hp, *shape, st)
            return held
        return run

    def k3(lib):
        outs = (torch.empty_like(d_raw), torch.empty_like(nrm))
        return lambda: (lib["tied_sae_bwd"].sc_tied_sae_bwd_grads(
            xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), db.data_ptr(), *(o.data_ptr() for o in outs),
            l1b.data_ptr(), M, B, N, D, st), outs)[1]

    # the tied-capacity path's K2: the code rebuilt from the bias, int8 mu
    # (codes and per-row scales), bf16 nu
    mu8 = torch.randint(-127, 128, (M, N, D), generator=g, device=dev).to(torch.int8)
    mu8_scale = torch.rand((M, N), generator=g, device=dev) * 1e-5 + 1e-6
    nu16 = (torch.rand((M, N, D), generator=g, device=dev) * 1e-6).to(bf16)

    def k2_rebuild(lib):
        held = (d_raw.clone(), mu8.clone(), mu8_scale.clone(), nu16.clone(), torch.empty(M, N, device=dev))
        hp = (1e-3, 0.9, 0.999, 1e-8, 1 - 0.9, 1 - 0.999)

        def run():
            d, q, qs, n_, gb = held
            lib["tied_sae_bwd_rc"].sc_tied_sae_bwd_adam_tiers(
                xb.data_ptr(), dxh.data_ptr(), bias.data_ptr(), nrm.data_ptr(), d.data_ptr(), q.data_ptr(),
                qs.data_ptr(), 2, n_.data_ptr(), None, 1, gb.data_ptr(), l1b.data_ptr(), bc.data_ptr(),
                seed.data_ptr(), 256, *hp, M, B, N, D, st)
            return held
        return run

    cases["tied_sae_fwd (config 2)"] = k1
    cases["tied_sae_fwd_nocode (config 2)"] = k1n
    cases["tied_sae_bwd_adam (config 2, mu bf16, nu f32)"] = k2
    cases["tied_sae_bwd_adam (config 2, code rebuilt, mu int8, nu bf16)"] = k2_rebuild
    cases["tied_sae_bwd_grads (config 2)"] = k3

    # TopK, config 4
    TM, TB, TN, TD = 7, 2048, 12288, 768
    ks = torch.tensor([1, 11, 31, 61, 91, 121, 151], dtype=torch.int32, device=dev)
    t_raw = torch.randn((TM, TN, TD), generator=g, device=dev)
    t_nrm = torch.sqrt(torch.sum(t_raw * t_raw, dim=-1))
    t_db = (t_raw / t_nrm[..., None]).to(bf16)
    t_xb = torch.randn((TB, TD), generator=g, device=dev).to(bf16)
    t_s = torch.empty((TM, TB, TN), dtype=bf16, device=dev)
    t_th = torch.empty((TM, TB), device=dev)
    t_c = torch.empty((TM, TB, TN), dtype=bf16, device=dev)
    t_dxh = torch.empty((TM, TB, TD), dtype=bf16, device=dev)
    t_lr = torch.empty((TM, TB), device=dev)  # K_d's loss partials: per row, or per 64 x 128 tile before
    t_scale = 2.0 / (TB * TD)
    fwd = libs["b"]["topk_fwd"]
    fwd.sc_topk_scores(t_xb.data_ptr(), t_db.data_ptr(), ks.data_ptr(), t_s.data_ptr(), t_th.data_ptr(),
                       TM, TB, TN, TD, st)
    fwd.sc_topk_decode(t_xb.data_ptr(), t_db.data_ptr(), t_s.data_ptr(), t_th.data_ptr(), t_c.data_ptr(),
                       t_dxh.data_ptr(), t_lr.data_ptr(), TM, TB, TN, TD, t_scale, st)

    def ks_(lib):
        outs = (torch.empty_like(t_s), torch.empty_like(t_th))
        return lambda: (lib["topk_fwd"].sc_topk_scores(t_xb.data_ptr(), t_db.data_ptr(), ks.data_ptr(),
                                                        *(o.data_ptr() for o in outs), TM, TB, TN, TD, st), outs)[1]

    def kd(lib):
        outs = (torch.empty_like(t_c), torch.empty_like(t_dxh), torch.empty_like(t_lr))
        return lambda: (lib["topk_fwd"].sc_topk_decode(t_xb.data_ptr(), t_db.data_ptr(), t_s.data_ptr(),
                                                        t_th.data_ptr(), *(o.data_ptr() for o in outs),
                                                        TM, TB, TN, TD, t_scale, st), outs)[1]

    t_mu = torch.randn((TM, TN, TD), generator=g, device=dev) * 1e-3
    t_nu = torch.rand((TM, TN, TD), generator=g, device=dev) * 1e-6
    t_l1b = torch.zeros(TM, device=dev)
    t_bc = torch.tensor([[0.1, 0.001]] * TM, device=dev)
    cases["topk_scores (config 4)"] = ks_
    cases["topk_decode (config 4)"] = kd
    cases["tied_sae_bwd_adam (config 4, mu f32, nu f32)"] = lambda lib: k2(
        lib, t_raw, t_mu, t_nu, t_xb, t_dxh, t_c, t_nrm, t_l1b, t_bc, (TM, TB, TN, TD))

    # the sparse route of the TopK paths: K2 with f32 moments, K2 at the
    # capacity tiers (int8 mu, bf16 nu, stores seeded over 128-row tiles),
    # K3
    t_mu8 = torch.randint(-127, 128, (TM, TN, TD), generator=g, device=dev).to(torch.int8)
    t_mu8_scale = torch.rand((TM, TN), generator=g, device=dev) * 1e-5 + 1e-6
    t_nu16 = t_nu.to(bf16)

    def k2_sparse(lib, int8):
        held = ((t_raw.clone(), t_mu8.clone(), t_mu8_scale.clone(), t_nu16.clone()) if int8
                else (t_raw.clone(), t_mu.clone(), None, t_nu.clone())) + (torch.empty(TM, TN, device=dev),)
        hp = (1e-3, 0.9, 0.999, 1e-8, 1 - 0.9, 1 - 0.999)

        def run():
            d, m_, ms, n_, gb = held
            lib["tied_sae_bwd_sparse"].sc_tied_sae_bwd_adam_sparse(
                t_xb.data_ptr(), t_dxh.data_ptr(), t_c.data_ptr(), t_nrm.data_ptr(), d.data_ptr(), m_.data_ptr(),
                ms.data_ptr() if int8 else None, 2 if int8 else 0, n_.data_ptr(), None, 1 if int8 else 0,
                gb.data_ptr(), t_l1b.data_ptr(), t_bc.data_ptr(), seed.data_ptr(), 128, *hp, TM, TB, TN, TD, st)
            return tuple(t for t in held if t is not None)
        return run

    def k3_sparse(lib):
        outs = (torch.empty_like(t_raw), torch.empty_like(t_nrm))
        return lambda: (lib["tied_sae_bwd_sparse"].sc_tied_sae_bwd_grads_sparse(
            t_xb.data_ptr(), t_dxh.data_ptr(), t_c.data_ptr(), t_nrm.data_ptr(), t_db.data_ptr(),
            *(o.data_ptr() for o in outs), t_l1b.data_ptr(), TM, TB, TN, TD, st), outs)[1]

    if all("tied_sae_bwd_sparse" in v for v in libs.values()):
        cases["tied_sae_bwd_adam_sparse (config 4, mu f32, nu f32)"] = lambda lib: k2_sparse(lib, False)
        cases["tied_sae_bwd_adam_sparse (config 4, mu int8, nu bf16)"] = lambda lib: k2_sparse(lib, True)
        cases["tied_sae_bwd_grads_sparse (config 4)"] = k3_sparse

    # K_f: config 3 at a cut iteration count, and row 8's shape
    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke as cs
    from sparse_coding__tpu_torch.models import fista as tf

    def k_f(shape, seed):
        FM, FB, FN, FD, iters = shape
        x, d, c0, l1 = cs.fista_problem(torch, FM, FB, FN, FD, seed)
        eta = tf.default_eta(d)
        mom = torch.from_numpy(tf.momentum_table(iters).copy()).to(dev)
        # the one-launch kernel's layouts: the batch fastest, the dictionary's transpose
        x_t, d_t, c0_t = x.t().contiguous(), d.transpose(1, 2).contiguous(), c0.transpose(1, 2).contiguous()

        def make(lib):
            k = next(t for t, v in libs.items() if v is lib)
            start = c0_t if one_launch_k_f[k] else c0
            a, y = start.clone(), start.clone()
            res = torch.empty((FM, FD, FB) if one_launch_k_f[k] else (FM, FB, FD), device=dev)
            sync = torch.zeros(1, dtype=torch.int32, device=dev)

            def run():
                a.copy_(start)
                y.copy_(start)
                sync.zero_()
                tail = (eta.data_ptr(), l1.data_ptr(), mom.data_ptr(), None, None, a.data_ptr(), y.data_ptr(),
                        res.data_ptr())
                if one_launch_k_f[k]:
                    lib["fista"].sc_fista_solve(x_t.data_ptr(), d.data_ptr(), d_t.data_ptr(), *tail, sync.data_ptr(),
                                                FM, FB, FN, FD, iters, st)
                    return (a.transpose(1, 2).contiguous(),)
                lib["fista"].sc_fista_solve(x.data_ptr(), d.data_ptr(), *tail, FM, FB, FN, FD, iters, st)
                return (a,)
            return run
        return make

    if all("fista" in v for v in libs.values()):
        cases[f"fista_solve (config 3, {args.fista_iters} iterations)"] = k_f(
            (4, 2048, 2048, 512, args.fista_iters), 12)
        cases["fista_solve (row 8: M 2, B 256, N 512, D 128, 100 iterations)"] = k_f((2, 256, 512, 128, 100), 11)

    configs = set(args.configs.split(","))
    if "5" in configs:
        # BASELINE config 5: K1, K1n; K2 on K1's code (f32 moments) and
        # rebuilding it (int8 mu, bf16 nu). K1's loss partials are
        # allocated for the larger of its two layouts (the WMMA tiles'
        # [M, B/64, N/128], the pipelined pair's [M, B/64, 2]); K1n's are
        # [M, B/32] in both (32-row blocks, or pairs of blocks a 64-row tile)
        M5, B5, N5, D5 = 4, 2048, 32768, 1024
        r5, b5, x5, n5, db5 = tied(M5, B5, N5, D5)
        s5 = 2.0 / (B5 * D5)
        c5 = torch.empty((M5, B5, N5), dtype=bf16, device=dev)
        dxh5 = torch.empty((M5, B5, D5), dtype=bf16, device=dev)
        part5 = torch.empty((M5, B5 // 64, N5 // 128), device=dev)
        libs["b"]["tied_sae_fwd"].sc_tied_sae_fwd(x5.data_ptr(), db5.data_ptr(), b5.data_ptr(), c5.data_ptr(),
                                                  dxh5.data_ptr(), part5.data_ptr(), torch.empty_like(part5).data_ptr(),
                                                  M5, B5, N5, D5, s5, st)
        l1b5 = torch.logspace(-4, -2, M5, device=dev) / B5
        bc5 = torch.tensor([[0.1, 0.001]] * M5, device=dev)

        def k1_5(lib):
            outs = (torch.empty_like(c5), torch.empty_like(dxh5), torch.empty_like(part5), torch.empty_like(part5))
            return lambda: (lib["tied_sae_fwd"].sc_tied_sae_fwd(
                x5.data_ptr(), db5.data_ptr(), b5.data_ptr(), *(o.data_ptr() for o in outs), M5, B5, N5, D5, s5,
                st), outs)[1][:2]

        def k1n_5(lib):
            outs = (torch.empty_like(dxh5), torch.empty((2, M5, B5 // 32), device=dev))
            return lambda: (lib["tied_sae_fwd"].sc_tied_sae_fwd_nocode(
                x5.data_ptr(), db5.data_ptr(), b5.data_ptr(), outs[0].data_ptr(), outs[1][0].data_ptr(),
                outs[1][1].data_ptr(), M5, B5, N5, D5, s5, st), outs)[1][:1]

        q5 = torch.randint(-127, 128, (M5, N5, D5), generator=g, device=dev).to(torch.int8)
        q5_scale = torch.rand((M5, N5), generator=g, device=dev) * 1e-5 + 1e-6
        nu5 = (torch.rand((M5, N5, D5), generator=g, device=dev) * 1e-6).to(bf16)

        def k2_rebuild_5(lib):
            held = (r5.clone(), q5.clone(), q5_scale.clone(), nu5.clone(), torch.empty(M5, N5, device=dev))
            hp = (1e-3, 0.9, 0.999, 1e-8, 1 - 0.9, 1 - 0.999)

            def run():
                d, q, qs, n_, gb = held
                lib["tied_sae_bwd_rc"].sc_tied_sae_bwd_adam_tiers(
                    x5.data_ptr(), dxh5.data_ptr(), b5.data_ptr(), n5.data_ptr(), d.data_ptr(), q.data_ptr(),
                    qs.data_ptr(), 2, n_.data_ptr(), None, 1, gb.data_ptr(), l1b5.data_ptr(), bc5.data_ptr(),
                    seed.data_ptr(), 256, *hp, M5, B5, N5, D5, st)
                return held
            return run

        cases["tied_sae_fwd (config 5)"] = k1_5
        cases["tied_sae_fwd_nocode (config 5)"] = k1n_5
        cases["tied_sae_bwd_adam (config 5, mu f32, nu f32)"] = lambda lib: k2(
            lib, r5, torch.zeros_like(r5), torch.zeros_like(r5), x5, dxh5, c5, n5, l1b5, bc5, (M5, B5, N5, D5))
        cases["tied_sae_bwd_adam (config 5, code rebuilt, mu int8, nu bf16)"] = k2_rebuild_5
    cases = {k: v for k, v in cases.items()
             if any(f"(config {c}" in k for c in configs) or ("row 8" in k and "3" in configs)}

    def timed(fn, reps):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    result = {}
    for name, make in cases.items():
        fns = {k: make(libs[k]) for k in libs}
        first = {k: [t.clone() for t in fns[k]()] for k in libs}  # one launch each, from the same state
        torch.cuda.synchronize()
        equal = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(first["a"], first["b"]))
        turns = [(k, timed(fns[k], args.reps)) for k in ("a", "b", "b", "a")]
        result[name] = {"ms": turns, "outputs_bit_equal": equal, "frac_differing": differing(torch, first)}
        del fns, first
        torch.cuda.empty_cache()
    del libs, cases
    torch.cuda.empty_cache()
    steps = {}
    saved = REPO / "build" / "kernel_ab" / "params"
    saved.mkdir(parents=True, exist_ok=True)
    for path in () if args.kernels_only else ("tied", "tied_capacity", "topk", "topk_capacity", "fista"):
        turns = []
        for i, k in enumerate(("a", "b", "b", "a")):
            save = ["--child-save", str(saved / f"{k}.pt")] if i < 2 else []  # the first turn of each checkout
            out = subprocess.run([sys.executable, __file__, "--child-tree", str(trees[k]), "--child-path", path,
                                  "--step-reps", str(args.step_reps), *save],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode:
                raise RuntimeError(f"step turn {k} {path} failed:\n{out.stdout}\n{out.stderr}")
            turns.append((k, json.loads(out.stdout.strip().splitlines()[-1])))
        digests = {k: r.pop("params_digest") for k, r in turns}
        params = {k: torch.load(saved / f"{k}.pt") for k in ("a", "b")}
        steps[path] = {"turns": turns, "params_bit_equal": len(set(digests.values())) == 1,
                       "params_frac_differing": differing(torch, {k: list(v.values()) for k, v in params.items()})}
        del params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"a": str(trees["a"]), "b": str(trees["b"]), "card": smi, "reps": args.reps,
                      "kernels": result, "step_reps": args.step_reps, "steps": steps}), flush=True)
    return 0


def differing(torch, outs):
    """Per output, the fraction of its elements whose bits differ between
    the two checkouts' (``outs`` {"a": [tensors], "b": [tensors]})."""
    return [float((a.view(torch.uint8).reshape(a.numel(), -1) != b.view(torch.uint8).reshape(b.numel(), -1))
                  .any(-1).float().mean()) if a.numel() else 0.0
            for a, b in zip(outs["a"], outs["b"])]


def child(tree: Path, path: str, reps: int, save: str = None) -> int:
    """One turn of the step timing: ``tree``'s package, chip_smoke.py's
    ensemble of ``path``; prints one JSON object, and saves the params
    after the timed steps to ``save`` when given."""
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    import sparse_coding__tpu_torch as pkg

    if not Path(pkg.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {pkg.__file__}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"tied": cs.TIED, "tied_capacity": cs.TIED_CAPACITY, "topk": cs.TOPK, "topk_capacity": cs.TOPK_CAPACITY,
           "fista": cs.FISTA}[path]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    if path == "fista":  # no fused step: the signature steps by autograd
        ens = pkg.build_ensemble(getattr(pkg, cfg["sig"]), 1, cfg["hparams"], **cfg["build"])
    else:
        ens = cs.build_path(pkg, cfg, 1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((cfg["batch"], cfg["width"]), generator=gen, device="cuda")
    if path == "fista":  # the gradient step, then the decoder update's solve
        from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

        update = make_fista_decoder_update(cs.FISTA_ITERS)
        reps = min(reps, 3)

        def step():
            _, aux = ens.step_batch(x)
            ens.state = update(ens.state, x, aux["c"])
    else:
        def step():
            ens.step_batch(x)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        step()
    end.record()
    enqueue = time.perf_counter() - t0
    end.synchronize()
    digest = hashlib.sha256()
    for key in sorted(ens.state.params):
        t = ens.state.params[key]
        if t is not None:
            digest.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    if save:
        torch.save({key: t.detach().cpu() for key, t in sorted(ens.state.params.items()) if t is not None}, save)
    print(json.dumps({"ms_per_step": start.elapsed_time(end) / reps, "host_enqueue_ms_per_step": enqueue * 1e3 / reps,
                      "step_peak_bytes": torch.cuda.max_memory_allocated() - before,
                      "params_digest": digest.hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
