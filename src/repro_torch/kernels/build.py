"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, at first use, into
``build/repro_torch_kernels/lib<name>-<hash>.so`` under the repository
root (``.gitignore`` lists ``build/``).  The hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per source, all together, and waits for them; it raises with the
compiler's output when one fails.

Every exported C function launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch; the
wrappers raise on a non-zero code (:func:`check_error`).  Each library
also exports ``repro_cuda_error_string(int)``.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = (
    "seg_gat_agg", "seg_gat_agg_multigraph", "seg_gat_agg_multigraph_bwd",
    "seg_gat_agg_fused_fp", "seg_gat_agg_fused_fp_bwd", "flash_attention", "fused_fp_coeff",
    "fused_adamw",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels build only on a host with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns each compiler's output (the
    ``-Xptxas -v`` register and shared-memory report); raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check_error(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# -- argument checks shared by the wrappers ----------------------------------


def check_tensor(name: str, t, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    (``None`` entries match any size) on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device} like the other operands")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy when its data is not 16-byte aligned (the edge
    kernels read rows as float4 and mask rows as 8 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
