"""Build and load the hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded
with :mod:`ctypes` — no PyTorch headers, so a build takes seconds.  Builds
happen at first use, into ``build/repro_torch/<hash>/`` at the repository
root (listed in ``.gitignore``), keyed by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags: an edited source rebuilds, an
unchanged one loads.  :func:`build`
starts one ``nvcc`` per missing library, all at once.

Only cudart is linked (nvcc's default): the TMA tensor maps of
``flash_attention.cu``, ``matmul_tm.cu`` and ``igemm.cuh`` get
``cuTensorMapEncodeTiled`` and ``cuTensorMapEncodeIm2col`` through
``cudaGetDriverEntryPoint``, so no library links ``libcuda``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  A build or launch
that fails raises — there is no fallback to another implementation.
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

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0: optimise a source's kernels on every core (matmul_tm.cu
# instantiates its product for 8 tile widths x 4 dtypes)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_P, _I64, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
_U64, _F = ctypes.c_uint64, ctypes.c_float
# argtypes of every C entry point, per source file
SIGNATURES: dict[str, dict[str, list]] = {
    "tm_affine": {
        "tm_affine_block": [_P, _P, _P, _P, _I, _I, _I64, _I, _I, _I, _I64,
                            _P],
        "tm_affine_gather": [_P, _P, _P, _P, _I, _I, _I64, _I, _I, _I, _I,
                             _P, _I, _P],
    },
    "tm_chain": {
        "tm_chain": [_P, _P, _P, _I, _I64, _I, _I, _P],
    },
    "rme_gather": {
        "rme_evaluate": [_P, _P, _P, _P, _I, _I64, _I64, _I64, _I64, _I64,
                         _I, _I, _D, _I64, _P],
        "rme_evaluate_chained": [_P, _P, _P, _I64, _P, _P, _P, _I, _I64,
                                 _I64, _I64, _I64, _I64, _I, _I, _D, _I64,
                                 _P],
        "rme_assemble": [_P, _P, _I, _P, _P, _I, _I64, _I64, _I64, _I64, _P],
    },
    "img2col": {
        "img2col": [_P, _P, _I, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                    _I64, _I64, _P, _U64, _U64, _I, _P],
        "conv2d": [_P, _P, _P, _I] + [_I] * 18 + [_P],
        "conv2d_blocks": [_I] * 5,
    },
    "resize": {
        "resize_bilinear": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    },
    "matmul_tm": {
        "matmul_tm": [_P, _P, _P, _I, _I64, _I64, _I64, _I64, _I64, _I,
                      _I64, _I64, _I64, _I64, _I, _I, _P],
    },
    "xchain_commit": {
        "xchain_commit": [_P] * 6 + [_I, _I64] + [_I] * 10 + [_P],
        "xchain_commit_blocks": [_I] * 5,
    },
    "xchain_prologue": {
        "xchain_prologue": [_P] * 7 + [_I, _I, _I64] + [_I] * 10 + [_P],
        "xchain_prologue_blocks": [_I] * 5,
    },
    "flash_attention": {
        "flash_attention_fwd": [_P, _P, _P, _P, _I] + [_I] * 6 + [_I64] * 12
        + [_F, _I, _P],
        "flash_attention_decode": [_P] * 6 + [_I] * 8 + [_I64] * 10
        + [_F, _P],
        "flash_attention_decode_partial": [_P] * 7 + [_I] * 8
        + [_I64] * 10 + [_F, _P],
    },
    "adamw": {
        "adamw_sumsq": [_P, _P, _P, _I, _P, _I64, _P, _P],
        "adamw_apply": [_P] * 7 + [_I] + [_P] * 4 + [_F] * 6 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process each, all started together.  Returns the wall seconds
    from the start to the end of each build that ran; raises with the
    compiler's output on failure."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).is_file()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(out.with_suffix(f".log{os.getpid()}"), "w+")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, out,
                       log)
    seconds, errors = {}, []
    while len(seconds) < len(procs):
        for name, (proc, tmp, out, log) in procs.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{text}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent build never loads half
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def current_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index`` (a
    tensor's ``get_device()``), as an int for a C entry point."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # no Stream object is made
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def through_op(*tensors: torch.Tensor) -> bool:
    """Whether a kernel wrapper whose kernel is a custom op sends its
    operands through the op: when any is a DTensor (a model under a mesh:
    the op's sharding rule then runs it on each rank's shards) or a fake
    tensor (a trace under FakeTensorMode: the op's fake gives the shapes).
    Plain tensors skip the dispatcher: the plain version on the CPU, the
    launch on any other device, which raises unless it is the card."""
    return any(isinstance(t, (DTensor, FakeTensor)) for t in tensors)
