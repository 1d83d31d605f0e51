"""Kernel substrate: resolve it once per process, build the CUDA library.

Two substrates:

    "cuda"  — the hand-written Hopper kernels of `repro_torch/csrc/*.cu`
              (CUDA available, device capability >= 9.0, library builds)
    "torch" — the plain PyTorch twins, for CPU tensors

The kernels are plain-C-interface shared libraries, one per source file,
compiled by `nvcc` at first use into `build/kernels/` at the repository root
and loaded with `ctypes`. All sources build at once, one `nvcc` process each.
A library's file name carries a hash of its source, the shared header and the
flags, so an edited source rebuilds and an unchanged one loads as it is. On a
machine with a card a build failure raises: nothing gives way to the twins.

Each kernel wrapper counts its launches here (`count_launch`), so a run can
show which kernels the main path went through. `launch_counts()` means
kernels the card ran: a CUDA graph capture records kernels and runs none, so
its counts are taken back out (`recorded_launches`) and added once for each
replay (`count_replay`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("delta_quant", "reuse_matmul", "reuse_matmul_ragged",
           "reuse_matmul_int8", "wkv6_decode", "wkv6_backward")
KERNELS = ("delta_quant", "reuse_matmul_output", "reuse_matmul_input",
           "reuse_matmul_ragged", "reuse_matmul_int8", "wkv6_decode",
           "wkv6_decode_backward")

# dtype codes of the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, by library
SIGNATURES = {
    "delta_quant": {
        # x, x_dtype, prev_q, scale, q, delta, delta_dtype, mask, M, K, bm, bk,
        # vec, stream
        "rt_delta_quant": (_P, _I, _P, _P, _P, _P, _I, _P,
                           _I, _I, _I, _I, _I, _P),
    },
    "reuse_matmul": {
        # delta, w, dtype, prev_out, mask, out, M, K, Kw, N, ldw, bm, bk,
        # cluster, stream
        "rt_reuse_matmul_output": (_P, _P, _I, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # delta, w, dtype, prev_out, mask, out, M, K, Kw, N, ldw, bm, bk,
        # stream
        "rt_reuse_matmul_input": (_P, _P, _I, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "reuse_matmul_ragged": {
        # delta, w, dtype, prev_out, counts, idx, idx_ld, out, M, K, Kw, N,
        # ldw, bm, bk, cluster, stream
        "rt_reuse_matmul_ragged": (_P, _P, _I, _P, _P, _P, _I, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "reuse_matmul_int8": {
        # delta, w, prev_acc, mask, out, M, K, N, bm, bk, stream
        "rt_reuse_matmul_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "wkv6_decode": {
        # r, k, v, w, u, state, state_out, out, BH, H, dk, dv, stream
        "rt_wkv6_decode": (_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P),
    },
    "wkv6_backward": {
        # r, k, v, w, u, state, gout, gstate, gr, gk, gv, gw, gu, BH, H, dk,
        # dv, stream
        "rt_wkv6_decode_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _P),
    },
}

launches: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


def launch_counts() -> dict[str, int]:
    return {name: int(launches[name]) for name in KERNELS}


@contextlib.contextmanager
def recorded_launches():
    """Collect the launches counted inside the block into the Counter this
    yields, and take them back out of the totals (a capture ran nothing)."""
    before = launches.copy()
    recorded: collections.Counter = collections.Counter()
    try:
        yield recorded
    finally:
        recorded.update(launches - before)
        launches.clear()
        launches.update(before)


def count_replay(recorded: collections.Counter) -> None:
    """One replay of a captured graph ran the launches its capture recorded."""
    launches.update(recorded)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str, extra: tuple[str, ...]) -> pathlib.Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(*, verbose: bool = False, force: bool = False) -> dict[str, str]:
    """Compile every kernel source, one `nvcc` each, all started together.

    Returns {source: compiler log}. `verbose` adds `-Xptxas -v`, whose log
    gives each kernel's registers, shared memory and spills (it also forces a
    rebuild, since a cached library has no log). Raises on any failure."""
    extra = ("-Xptxas", "-v") if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name, ())
        if out.exists() and not (force or verbose):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "kernel build failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return logs


def sass(name: str) -> str:
    """The SASS of one built kernel library, by `cuobjdump -sass` (which the
    CUDA toolkit keeps beside nvcc)."""
    cuobjdump = pathlib.Path(_nvcc()).resolve().parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_lib_path(name, ()))],
                          capture_output=True, text=True, check=True).stdout


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built if missing)."""
    path = _lib_path(name, ())
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (a host query)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1)
def best() -> str:
    """The substrate of this process: "cuda" when CUDA is available, the card
    is Hopper or newer and the kernel library builds; else "torch"."""
    if not torch.cuda.is_available():
        return "torch"
    if torch.cuda.get_device_capability(0) < (9, 0):
        return "torch"
    for name in SOURCES:
        library(name)  # raises on a build failure — never degrades
    return "cuda"


def require_device(name: str) -> torch.device:
    """A launcher's `--device`: "cpu" as it is; "cuda" only with a card on
    which the kernel substrate resolves to "cuda", else RuntimeError."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda (the default) but no CUDA device is available;"
                " pass --device cpu to run the plain PyTorch versions")
        if best() != "cuda":
            raise RuntimeError(
                f"the kernel substrate is {best()!r}: the Hopper "
                "kernels need a device of capability 9.0 or newer")
    return torch.device(name)


def tag() -> dict:
    """Provenance stamp: substrate, versions and the device it resolved on."""
    sub = best()
    on_card = sub == "cuda"
    return {
        "backend": sub,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": "cuda:0" if on_card else "cpu",
        "device_name": torch.cuda.get_device_name(0) if on_card else "cpu",
    }


def describe() -> str:
    """One-line summary for startup logs."""
    t = tag()
    return (f"backend={t['backend']} device={t['device']} "
            f"({t['device_name']}) torch={t['torch']} cuda={t['cuda']} "
            f"python={sys.version.split()[0]}")
