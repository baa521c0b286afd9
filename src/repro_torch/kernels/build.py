"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc -gencode arch=compute_90a,
code=sm_90a` into its own shared library with a plain C interface, loaded
through `ctypes` (no PyTorch headers, so a build takes seconds).  Builds
happen at first use into `build/repro_torch/` at the repository root (listed
in `.gitignore`), one `nvcc` per source started together, and a library is
rebuilt whenever the content hash of the sources changes.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_matmul", "fused_swiglu", "flash_attention",
           "paged_decode", "decode_attention", "rmsnorm", "ssd")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}   # bound entry points
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
                torch.int8: 2}                         # common.cuh DTypeCode
_raw_stream = None   # torch's current-raw-stream binding, found at first use


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> List[dict]:
    """Compile every source whose library is missing or stale, all nvcc
    processes in parallel.  Returns this call's build records."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return []
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    running = [(n, *_start(n, nvcc)) for n in todo]
    records, failed = [], []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        rec = {"name": name, "seconds": time.perf_counter() - t0,
               "returncode": proc.returncode, "log": log}
        records.append(rec)
        if proc.returncode != 0:
            failed.append(rec)
            continue
        os.replace(tmp, out)
    if failed:
        msg = "\n".join(f"--- {r['name']} (rc {r['returncode']})\n{r['log']}"
                        for r in failed)
        raise RuntimeError(f"nvcc failed:\n{msg}")
    return records


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of library `name` with its argument types
    declared (pointers and the stream as c_void_p, never as 32-bit ints),
    bound at its first call and kept: a wrapper calls this on every
    launch."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def dtype_code(t) -> int:
    """Element-type code the kernels take (common.cuh DTypeCode)."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32, bfloat16 or int8, "
                        f"not {t.dtype}")
    return code


def require_cuda(what: str, *tensors) -> None:
    """A kernel launch needs every operand (None: absent) on one CUDA
    device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in tensors[1:]):
        got = [str(t.device) for t in tensors if t is not None]
        raise ValueError(f"{what}: the CUDA kernel needs every operand on "
                         f"one CUDA device, got {', '.join(got)}")


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def ptr(t):
    """A tensor's device address for a C entry point; None (NULL) for an
    absent operand."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t,
    through the binding PyTorch's own generated code uses when it has one
    (`torch.cuda.current_stream` resolves the device on every call, and a
    decode step makes hundreds of launches); the binding is looked up once."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
    return _raw_stream(t.get_device())


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error (launch refused,
    bad arguments): such a launch never ran."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error code {err} (cudaError_t)")
