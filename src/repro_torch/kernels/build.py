"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, from the checkout's sources alone, one ``nvcc`` process
per source, all started together, into ``build/repro_torch/<hash>/`` at the
repository root (git-ignored); the hash covers every source and flag, so an
edited source rebuilds and a stale library is never loaded.  Nothing is
compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("smlm", "bgmv", "prefill_attn", "decode_attn", "verify_attn",
           "splitk", "flash_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# loaded libraries and bound entry points, keyed by library / symbol name
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def repo_root() -> Path:
    return CSRC.parents[3]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return repo_root() / "build" / "repro_torch" / _digest()


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: Sequence[str] = KERNELS, verbose: bool = False
          ) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel; raise with the compiler's output if any fails.  ``verbose``
    adds ``-Xptxas -v`` (registers, shared memory, spills per kernel) and
    prints what the compiler says."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: lib_path(n) for n in names}


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The ``extern "C"`` entry ``symbol`` of library ``lib`` with its
    argument types declared (pointers and the stream as ``c_void_p``, so
    ctypes never truncates them to 32 bits), building all libraries first if
    this one is missing."""
    key = (lib, symbol)
    fn = _FNS.get(key)
    if fn is None:
        if lib not in _LIBS:
            path = lib_path(lib)
            if not path.exists():
                build()
            _LIBS[lib] = ctypes.CDLL(str(path))
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def check(err: int, lib: str) -> None:
    """Raise when a launch entry of ``lib`` returned a CUDA error code."""
    if err:
        text = _LIBS[lib].repro_error_string
        text.argtypes = [ctypes.c_int]
        text.restype = ctypes.c_char_p
        raise RuntimeError(f"{lib}: CUDA error {err} "
                           f"({text(err).decode(errors='replace')})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODE.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device (the current one) and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev, f"tensors on {t.device} and {dev}")
        require(t.is_contiguous(), "kernel inputs must be contiguous")
    require(dev.index == torch.cuda.current_device(),
            f"tensor on {dev} but the current device is "
            f"cuda:{torch.cuda.current_device()}")
    return dev


def check_vectors(*tensors: torch.Tensor) -> None:
    """The attention kernels copy rows as 16-byte vectors: every tensor
    must start on a 16-byte boundary (a fresh tensor does; a view may
    not)."""
    for t in tensors:
        require(t.data_ptr() % 16 == 0,
                "attention inputs must start on a 16-byte boundary")
