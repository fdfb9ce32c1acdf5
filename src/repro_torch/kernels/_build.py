"""Build and bind the port's CUDA kernels: nvcc -> one shared library -> ctypes.

The library is built at first use, from the sources under ``csrc/`` alone,
into ``_build/`` beside this file (listed in ``.gitignore``) under a name
keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree loads the existing file.  Each ``.cu`` compiles in its own
``nvcc`` process, all started together, and the objects link into one
``.so``.  The kernels include no PyTorch header, so a build takes seconds.
Each kernel wrapper also counts its launches here (:func:`record_launch`).

Flags: ``sm_90a``, ``-O3``, and no ``--use_fast_math``, so ``sqrtf`` and
``/`` are IEEE-rounded as in PyTorch's elementwise ops; ``screen.cu`` and
``snapshot.cu`` also get ``-fmad=false`` so their verdicts and norms are
bit-identical to the plain versions.  The factorized cost (``cost.cuh``),
the snapshot norms, the gradient body (``gradpsi.cu``) and the row
reductions (``reduce.cu``) round each step with ``__fmul_rn`` /
``__fadd_rn`` / ``__fmaf_rn`` / ``__fsqrt_rn`` and so need no flag: which
products are fused is written in the source, not left to the compiler.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

# Each wrapper adds one where it launches its CUDA kernel, and nowhere else.
_LAUNCHES: Dict[str, int] = {}


def record_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Snapshot of {kernel wrapper name: CUDA launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Zero the launch counters."""
    _LAUNCHES.clear()


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"] + ARCH
SOURCES: Dict[str, List[str]] = {
    "screen.cu": ["-fmad=false"],
    "gradpsi.cu": [],
    "snapshot.cu": ["-fmad=false"],
    "reduce.cu": [],
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "screen_launch": [_P] * 12 + [_I] * 5 + [_P],
    "gradpsi_grid_launch": [_P] * 11 + [_I] * 7 + [_F, _F, _P],
    "gradpsi_compact_launch": [_P, _I] + [_P] * 11 + [_I] * 7 + [_F, _F, _P],
    "gradpsi_fact_grid_launch": [_P] * 14 + [_I] * 9 + [_F, _F, _P],
    "gradpsi_fact_compact_launch": [_P, _I] + [_P] * 14 + [_I] * 9 + [_F, _F, _P],
    "gradpsi_fused_launch": [_P] * 20 + [_I] * 7 + [_F, _F, _P],
    "gradpsi_fused_fact_launch": [_P] * 23 + [_I] * 9 + [_F, _F, _P],
    "snapshot_fact_launch": [_P] * 10 + [_I] * 10 + [_P],
    "snapshot_dense_launch": [_P] * 7 + [_I] * 8 + [_P],
    "row_sum_launch": [_P, _P, _I, _I, _I, _P],
    "row_dot_launch": [_P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr((COMMON_FLAGS, SOURCES)).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Build the library if missing; return (path, seconds, compiler log).

    ``verbose`` adds ``-Xptxas -v`` so the log lists each kernel's
    registers, shared memory and spills.
    """
    out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if out.exists():
        return out, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name, extra in SOURCES.items():
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, "-c", str(CSRC / name), "-o", obj, *COMMON_FLAGS, *extra]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", *ARCH, "-o", tmp_so, *(obj for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
        os.replace(tmp_so, out)           # atomic: concurrent builds are safe
    return out, time.perf_counter() - t0, "\n".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), argtypes declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a ``torch.device``).

    Read through the raw accessor Triton's launcher uses, which skips
    building a ``torch.cuda.Stream``: a kernel call's host time is most of
    what a sparse evaluation costs.
    """
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
