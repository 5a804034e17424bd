"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is built at first use
into ``build/loner_tpu_torch_kernels/<hash>/`` beside the package, keyed by a
hash of the sources and flags, so a fresh checkout builds it once and an edit
to a source rebuilds it. Nothing here runs at import.

Each C entry point launches on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; :func:`check` raises when that is not 0.
Each Python wrapper counts its launches in its ``launches`` attribute and is
listed in :data:`COUNTED` (:func:`counted`), so that a CUDA graph can add the
launches it holds on each replay (``mapping/step_graph.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "loner_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libloner_tpu_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # pts, lines, out, n, n_levels, n_features, res, stream
    "loner_cp_fwd": (_P, _P, _P, _LL, _I, _I, _P, _P),
    # pts, lines, g, dlines, dpts, n, n_levels, n_features, res, mm_bf16,
    # runs, threads, smem_bytes, stream
    "loner_cp_bwd": (_P, _P, _P, _P, _P, _LL, _I, _I, _P, _I, _I, _I, _LL, _P),
    # bins, cdf, u, out, n_rays, m, k, eps, stream
    "loner_pdf_sample": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # pts, v_t, out, n, n_levels, n_features, scales, stream
    "loner_fused_fwd": (_P, _P, _P, _LL, _I, _I, _P, _P),
    # pts, v_t, g, dpts, n, n_levels, n_features, scales, stream
    "loner_fused_dpts": (_P, _P, _P, _P, _LL, _I, _I, _P, _P),
    # pts, g, d, n, n_levels, n_features, scales, res, dense, table_size, row0, rows, stream
    "loner_fused_dtable": (_P, _P, _P, _LL, _I, _I, _P, _P, _P, _LL, _LL, _LL, _P),
    # pts, lines, out, n, n_levels, n_features, res, stream
    "loner_cp_gather_fwd": (_P, _P, _P, _LL, _I, _I, _P, _P),
    # idx, upd, acc, n, t, w, nshadow, acc_bf16, vec, stream
    "loner_row_scatter_add": (_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P),
    # acc, out, t * w, nshadow, acc_bf16, stream
    "loner_shadow_sum": (_P, _P, _LL, _I, _I, _P),
    # table, idx, out, n, t, w, vec4, stream
    "loner_row_gather": (_P, _P, _P, _LL, _LL, _LL, _I, _P),
    # table_t, idx, (t, w rounded up to 4) scratch, out, n, t, w, stream
    "loner_col_gather": (_P, _P, _P, _P, _LL, _LL, _LL, _P),
    # tab, idx, out, rows, cols, stream
    "loner_lane_gather": (_P, _P, _P, _LL, _LL, _P),
    # tab, idx, out, rows, cols, stream
    "loner_sublane_gather": (_P, _P, _P, _LL, _LL, _P),
    # tab, idx, out, chunks, rows, cols, stream
    "loner_two_stage_gather": (_P, _P, _P, _LL, _LL, _LL, _P),
    # blocks, stream
    "loner_empty_grid": (_LL, _P),
}

_lib: Optional[ctypes.CDLL] = None
COUNTED: list = []  # every wrapper with a ``launches`` counter, in the order they were defined
build_log = ""  # nvcc's output (ptxas register/shared-memory report) of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, out_dir: Path) -> None:
    nvcc = _nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir.parent))
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, objs = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            objs.append(str(obj))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / _LIB_NAME), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)  # atomic: a concurrent build may have won
        except OSError:
            if not (out_dir / _LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    if not (out_dir / _LIB_NAME).exists():
        _build(sources, out_dir)
    build_log = (out_dir / "build.log").read_text() if (out_dir / "build.log").exists() else ""
    lib = ctypes.CDLL(str(out_dir / _LIB_NAME))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def counted(wrapper):
    """Give ``wrapper`` a ``launches`` counter at 0 and list it in :data:`COUNTED`."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and ``shape``)
    on ``device``, or on a CUDA device when ``device`` is None."""
    if device is not None and t.device != torch.device(device):
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if device is None and t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
