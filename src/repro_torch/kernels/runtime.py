"""Build, load and launch the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled at first use, on the
machine that has the card, with ``nvcc`` into a shared library with a plain
C interface (``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout) and bound with :mod:`ctypes`. The hash covers the source, every
``.cuh`` header beside it and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source, all at once.

Every C entry returns ``cudaGetLastError()`` after its launch;
:meth:`KernelLibrary.check` raises when that is not ``cudaSuccess``. Kernels
launch on PyTorch's current stream and do not synchronise.

The module also owns the port's device rule: entry points run on ``cuda``
unless the caller asks for the CPU, and a request that cannot be met raises
instead of carrying on quietly on the CPU. A ``meta`` tensor (shapes and
dtypes, no data) takes neither the kernel nor its plain version: each
wrapper's shape rule returns empty ``meta`` outputs and reports the
kernel's work to the active :class:`WorkTally` (:func:`count_work`), which
is how ``launch/roofline.py`` counts a step without a device.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each library's launch entry (pointers and the stream are
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    "lut_matmul": ("lut_matmul_launch",
                   [_P] * 4 + [_I] * 5 + [_P] + [_I] * 6 + [_P, _I, _P]),
    "fused_lut_dense": ("fused_lut_dense_launch",
                        [_P] * 7 + [_I] * 8 + [_P] + [_I] * 6 + [_P, _I,
                                                              _P]),
    "fused_lut_conv": ("fused_lut_conv_launch",
                       [_P] * 7 + [_I] + [_I] * 15 + [_I] * 4 + [_I] * 9
                       + [_P]),
    "fused_lut_conv_tiled": ("fused_lut_conv_tiled_launch",
                             [_P] * 7 + [_I] + [_I] * 15 + [_I] * 4
                             + [_I] * 7 + [_I, _P]),
    "fused_lut_bwd": ("fused_lut_bwd_launch",
                      [_P] * 6 + [_I] * 8 + [_P] + [_I] * 9 + [_P]
                      + [_I] * 2 + [_P]),
    "fused_lut_conv_bwd_w": ("fused_lut_conv_bwd_w_launch",
                             [_P] * 7 + [_I] * 15 + [_I] * 4 + [_I] * 10
                             + [_P]),
    "approx_flash_attention": ("approx_flash_attention_launch",
                               [_P] * 12 + [_I] * 12 + [_L] * 9 + [_I] * 7
                               + [ctypes.c_float] + [_I] * 4 + [_P]),
    "err_matmul": ("err_matmul_launch", [_P] * 5 + [_I] * 9 + [_P]),
    "fused_lut_grouped": ("fused_lut_grouped_launch",
                          [_P, _I] + [_P] * 7 + [_I] * 10 + [_P] + [_I] * 8
                          + [_P, _I, _P]),
    "quantize": ("quantize_launch",
                 [_P, _I, _P, _P, _P, _I, _I] + [_L] * 17 + [_I] * 7
                 + [_L] * 3 + [_P]),
    "wkv": ("wkv_launch", [_P] * 9 + [_I] * 5 + [_L] * 12 + [_P]),
    "wkv_bwd": ("wkv_bwd_launch", [_P] * 16 + [_I] * 5 + [_P]),
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 11 + [_L] * 12 + [_I] * 3
                        + [ctypes.c_float] * 2 + [_I, _P]),
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when a CUDA device is wanted and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def _nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


class KernelLibrary:
    """One compiled ``.so`` and its launch entry, with ``argtypes`` set."""

    def __init__(self, name: str, path: Path):
        self.name = name
        self.path = path
        self._lib = ctypes.CDLL(str(path))
        entry, argtypes = SIGNATURES[name]
        self.launch = getattr(self._lib, entry)
        self.launch.argtypes = argtypes
        self.launch.restype = ctypes.c_int
        self._lib.lut_error_string.argtypes = [ctypes.c_int]
        self._lib.lut_error_string.restype = ctypes.c_char_p

    def check(self, code: int) -> None:
        if code != 0:
            msg = self._lib.lut_error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {code} ({msg})")


class KernelBuilder:
    """Compiles on first use and caches the loaded libraries by name."""

    def __init__(self):
        self._libs: dict[str, KernelLibrary] = {}
        self._lock = threading.Lock()
        self.logs: dict[str, str] = {}

    def build_all(self, names=tuple(SIGNATURES)) -> dict[str, str]:
        """Compile every missing library, one ``nvcc`` per source, all
        started together. Returns the compiler output of each build."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            self.logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)    # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return dict(self.logs)

    def get(self, name: str) -> KernelLibrary:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    self.build_all((name,))
                lib = self._libs[name] = KernelLibrary(name, path)
            return lib


BUILDER = KernelBuilder()


def kernel_library(name: str) -> KernelLibrary:
    return BUILDER.get(name)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_config(t: torch.Tensor) -> tuple[int, int]:
    """(persistent grid size, current stream handle) for tensors on ``t``'s
    device: one block per SM, since the shared-memory table leaves room for
    one block per SM."""
    index = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return sm_count(index), torch.cuda.current_stream(t.device).cuda_stream


def lut_to_int16(lut: torch.Tensor) -> torch.Tensor:
    """The product table narrowed to int16 for the kernels' shared memory,
    flattened. Raises for a table whose entries do not fit int16 or that is
    larger than 256 x 256 (its int16 copy must fit one block's shared
    memory). Reads the range back to the host, so callers convert once and
    keep the result (``Acu.kernel_lut``)."""
    flat = lut.reshape(-1)
    n = int(round(flat.numel() ** 0.5))
    if n * n != flat.numel() or n > 256:
        raise ValueError(f"LUT of {flat.numel()} entries is not a square "
                         f"table of at most 256 x 256 codes")
    if flat.dtype == torch.int16:
        return flat.contiguous()
    lo, hi = int(flat.min()), int(flat.max())
    if lo < -32768 or hi > 32767:
        raise ValueError(f"LUT range [{lo}, {hi}] does not fit int16; the "
                         f"shared-memory kernels cannot hold this table")
    return flat.to(torch.int16).contiguous()


def check_cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                       device: Optional[torch.device] = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         f"index with 32-bit ints")


@dataclasses.dataclass
class KernelWork:
    calls: int = 0
    lookups: float = 0.0      # LUT gathers
    flops: float = 0.0
    bytes: float = 0.0        # operands read once, results written once


class WorkTally:
    """The work the kernels' ``meta`` shape rules report, by kernel."""

    def __init__(self):
        self.by_kernel: dict[str, KernelWork] = {}

    def add(self, name: str, lookups: float, flops: float,
            bytes_: float) -> None:
        w = self.by_kernel.setdefault(name, KernelWork())
        w.calls += 1
        w.lookups += lookups
        w.flops += flops
        w.bytes += bytes_


_TALLY = threading.local()


@contextlib.contextmanager
def tally_work(tally: WorkTally):
    """Make ``tally`` the one :func:`count_work` adds to, in this thread."""
    prev = getattr(_TALLY, "active", None)
    _TALLY.active = tally
    try:
        yield tally
    finally:
        _TALLY.active = prev


def count_work(name: str, *, lookups: float = 0.0, flops: float = 0.0,
               bytes_: float = 0.0) -> None:
    """Called by a wrapper's ``meta`` shape rule in place of a launch: adds
    the kernel's work to the active tally, if there is one."""
    tally = getattr(_TALLY, "active", None)
    if tally is not None:
        tally.add(name, lookups, flops, bytes_)


def nbytes(*ts) -> int:
    """Bytes of the given tensors (numel x itemsize; a Python number or
    None counts as one float32 or nothing)."""
    total = 0
    for t in ts:
        if t is None:
            continue
        total += t.numel() * t.element_size() if isinstance(
            t, torch.Tensor) else 4
    return total


def meta_empty(*shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")
