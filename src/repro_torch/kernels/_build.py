"""Build the CUDA sources under ``csrc/`` into one shared library.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
``.cu`` file compiles to an object in its own ``nvcc`` process, all
started together, and the objects link into ``build/kernels/`` at the
repository root, named by a hash of the sources and flags.  The build
runs on first use, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C entry point -> argtypes; every launch entry returns cudaGetLastError()
SIGNATURES = {
    # q, k, v, o, lse, strides[12], B, H, KV, S, D, causal, window, bf16,
    # stream
    "flash_attention_fwd_launch": [_P] * 5 + [_STRIDES] + [_I] * 8 + [_P],
    # q, k, v, o, dout, lse, work, dq, dk, dv, strides[24], B, H, KV, S, D,
    # causal, window, bf16, stream
    "flash_attention_bwd_launch": [_P] * 10 + [_STRIDES] + [_I] * 8 + [_P],
    # B, H, KV, S, D, causal, window -> floats of the backward's f32 scratch
    "flash_attention_bwd_workspace": [_I] * 7,
    # q, k_pages, v_pages, tables, lens, out, B, H, KV, D, page, nb,
    # q_bf16, kv_bf16, stream
    "paged_attention_bhd_launch": [_P] * 6 + [_I] * 8 + [_P],
    # logits, gumbel, tok, lp, B, V, temperature, top_k, top_p,
    # vocab_size, stream
    "fused_sample_bv_launch": [_P] * 4 + [_I, _I, _F, _I, _F, _I, _P],
    # a, w, w_up, out, rows, E, C, D, F, bf16, stream
    "grouped_matmul_launch": [_P] * 5 + [_I] * 5 + [_P],
    # x, idx, slot, counts, buf, T, k, d, E, C, bf16, stream
    "moe_dispatch_launch": [_P] * 5 + [_I] * 6 + [_P],
    # out, slot, gate, y, T, k, d, bf16, stream
    "moe_combine_launch": [_P] * 4 + [_I] * 4 + [_P],
    # state, x, dt, A, Bm, Cm, D, y, out, strides[13], B, H, P, N, bf16,
    # stream
    "ssm_state_update_launch": [_P] * 9 + [_STRIDES] + [_I] * 5 + [_P],
    # x, dt, A, Bm, Cm, D, y, states, strides[23], B, H, L, P, N, s, bf16,
    # stream
    "ssd_scan_fwd_launch": [_P] * 8 + [_STRIDES] + [_I] * 7 + [_P],
    # x, dt, A, Bm, Cm, D, dy, states, dsend (unused), dx, ddt, dbp, dcp,
    # dap, ddp, strides[23], B, H, L, P, N, s, bf16, stream
    "ssd_scan_bwd_launch": [_P] * 15 + [_STRIDES] + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    for cand in (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                 / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cuh headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprokernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if the hashed library is missing) and return its path.
    The compiler's resource report (``-Xptxas -v``) lands beside it as
    ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = sources()
        objs = [Path(tmp) / (s.stem + ".o") for s in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(cus, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_so), "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp_so, out)  # atomic: a concurrent process sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_longlong if name.endswith("_workspace")
                      else ctypes.c_int)
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
