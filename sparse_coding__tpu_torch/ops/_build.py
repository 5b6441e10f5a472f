"""Build and load the port's hand-written CUDA kernels (`ops/csrc/*.cu`).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). The libraries go to ``build/sc_torch_kernels/`` beside the package,
named by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds and an unchanged one is loaded
as it is. All sources compile at once, one
``nvcc`` each. Nothing is built at import time: the first CUDA launch calls
`load`. A missing or failing ``nvcc`` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from sparse_coding__tpu_torch.ops._wrap import MAX_SMEM

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sc_torch_kernels"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DSC_MAX_SMEM={MAX_SMEM}",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes per exported C function: every pointer and the stream as c_void_p
# (ctypes would otherwise pass a Python int as a 32-bit int and cut it)
SIGNATURES = {
    "sc_tied_sae_fwd": [_P] * 7 + [_I] * 4 + [_F, _P],
    "sc_tied_sae_bwd_grads": [_P] * 8 + [_I] * 4 + [_P],
    "sc_tied_sae_fwd_nocode": [_P] * 6 + [_I] * 4 + [_F, _P],
    "sc_tied_sae_bwd_adam_tiers": [_P] * 7 + [_I] + [_P] * 2 + [_I] + [_P] * 4 + [_I] + [_F] * 6
    + [_I] * 4 + [_P],
    "sc_tied_sae_bwd_adam_sparse": [_P] * 7 + [_I] + [_P] * 2 + [_I] + [_P] * 4 + [_I] + [_F] * 6
    + [_I] * 4 + [_P],
    "sc_tied_sae_bwd_grads_sparse": [_P] * 8 + [_I] * 4 + [_P],
    "sc_tied_sae_bwd_plan": [_I, _I, _P],
    "sc_tied_sae_fwd_plan": [_I, _P],
    "sc_topk_scores": [_P] * 5 + [_I] * 4 + [_P],
    "sc_topk_select": [_P] * 3 + [_I] * 3 + [_P],
    "sc_topk_decode": [_P] * 7 + [_I] * 4 + [_F, _P],
    "sc_fista_solve": [_P] * 12 + [_I] * 5 + [_P],
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or NVCC_FALLBACK
    if not Path(found).is_file():
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {NVCC_FALLBACK}): the "
            "port's CUDA kernels are built from ops/csrc at first use"
        )
    return found


def _tag(src: Path) -> str:
    """Hash of the source, the shared headers it may include, and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every `csrc/*.cu`; returns {stem: CDLL}.
    The C functions get their `argtypes`/`restype` set here."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        pending = {}
        for src in sources:
            tag = _tag(src)
            lib = BUILD_DIR / f"lib{src.stem}.{tag}.so"
            log = BUILD_DIR / f"{src.stem}.{tag}.ptxas.txt"
            if lib.is_file() and log.is_file():
                _LOGS[src.stem] = log.read_text()
                continue
            tmp = lib.with_name(f".{lib.name}.tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending[src.stem] = (proc, tmp, lib, log)
        failures = []
        for stem, (proc, tmp, lib, log) in pending.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed on {stem}.cu (rc {proc.returncode}):\n{out}")
                continue
            log.write_text(out)
            os.replace(tmp, lib)
            _LOGS[stem] = out
        if failures:
            raise RuntimeError("\n".join(failures))
        for src in sources:
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}.{_tag(src)}.so"))
            for name, argtypes in SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            if hasattr(lib, "sc_cuda_error_string"):
                lib.sc_cuda_error_string.argtypes = [ctypes.c_int]
                lib.sc_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[src.stem] = lib
        return _LIBS


def ptxas_log() -> Dict[str, str]:
    """The ``-Xptxas -v`` output (registers, shared memory, spills) of each
    library `load` built or found; empty before the first `load`."""
    return dict(_LOGS)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        msg = load()["tied_sae_fwd"].sc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
