"""Build and load the port's CUDA kernels and its host library.

Every ``graphax_torch/kernels/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``graphax_torch/kernels/_build/`` (listed in ``.gitignore``), and loaded
with ``ctypes``. All sources compile in parallel, one ``nvcc`` each. A
library is named by the hash of its source, so an edited source is rebuilt
and an unchanged one is reused within one checkout.

The host code of ``graphax_torch/native/*.cpp`` (the community partitioner)
is built the same way by ``g++`` into ``graphax_torch/native/_build/``
(:func:`host_library`); it runs on the CPU, so the CPU tests build it too.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card has no ``nvcc``."""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# launches of each kernel, counted by its wrapper where it launches and
# nowhere else, through count_launch (chip_smoke.py zeroes them around the
# main path)
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()

_LIBS: dict = {}
# held while a library is built or loaded: trials training in threads (the
# sweep's concurrent trials) may reach their first launch together
_BUILD_LOCK = threading.RLock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C signature of every exported function: name -> argtypes (restype int,
# the cudaError_t of the launch)
SIGNATURES = {
    "spmm": {
        "gx_spmm_csr": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P],
        "gx_sddmm_csr": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    },
    "attention_pin": {
        "gx_attention_pin": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P],
    },
    "fused_attention": {
        "gx_attention_kproj": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
        "gx_attention_kproj_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "gx_attention_gmax": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                              _I, _F, _F, _F, _F, _I, _I, _P],
        "gx_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "gx_attention_fwd_res": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
        "gx_attention_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
        "gx_attention_bwd_cols": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _P],
        "gx_attention_norm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I,
                              _P],
        "gx_attention_attspmm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "winatt": {
        "gx_winatt": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _P],
    },
    "flash_dense": {
        "gx_flash_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "windowed_spmm": {
        "gx_densify": [_P, _P, _P, _P, _I, _L, _I, _I, _P],
        "gx_win_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
        "gx_win_bwd_dense": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
        "gx_win_bwd_slab": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    },
}

HOST_DIR = os.path.join(os.path.dirname(HERE), "native")
HOST_BUILD_DIR = os.path.join(HOST_DIR, "_build")
_HOST_SIGNATURES = {
    "graphbuild": {
        "gx_partition_grow": (_L, [_P, _P, _L, _L, _L, _L, _P]),
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from graphax_torch/kernels/csrc at first use")


def _library_path(src: str, build_dir: str, name: str,
                  headers: tuple = ()) -> str:
    """``build_dir/lib<name>-<hash of src and headers>.so``."""
    h = hashlib.sha1()
    for path in (src,) + tuple(headers):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:12]}.so")


def _target(name: str) -> tuple:
    """The source of ``name`` and its library, named by the hash of the
    source and of every shared header in ``csrc`` (``*.cuh``)."""
    src = os.path.join(CSRC, name + ".cu")
    headers = tuple(sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                           if f.endswith(".cuh")))
    return src, _library_path(src, BUILD_DIR, name, headers)


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``; a wrapper calls it where it launches
    its kernel. Under a lock: threads launching at once lose no count."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _tmp_name(so: str) -> str:
    """A temporary output beside ``so``, unique to this process and
    thread."""
    return so + f".tmp{os.getpid()}-{threading.get_ident()}"


def build_all(verbose: bool = False) -> float:
    """Compile every source that has no up-to-date library (in parallel)
    and load all of them. Returns the seconds spent. One thread builds at a
    time; another that enters meanwhile waits and then finds the libraries
    built and loaded."""
    with _BUILD_LOCK:
        return _build_all(verbose)


def _build_all(verbose: bool) -> float:
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    for name in SIGNATURES:
        if name in _LIBS:
            continue
        src, so = _target(name)
        if os.path.exists(so):
            continue
        nvcc = nvcc or _nvcc()
        tmp = _tmp_name(so)
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-lineinfo", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, src]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, so, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{text}")
            continue
        if verbose and text.strip():
            print(text)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in SIGNATURES:
        _load(name)
    return time.perf_counter() - t0


def _load(name: str) -> ctypes.CDLL:
    """Load the built library of ``name`` (under ``_BUILD_LOCK``)."""
    if name in _LIBS:
        return _LIBS[name]
    _, so = _target(name)
    lib = ctypes.CDLL(so)
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library of ``native/<name>.cpp``, built by ``g++``
    at first use. A failed build raises."""
    key = "host:" + name
    if key in _LIBS:
        return _LIBS[key]
    with _BUILD_LOCK:
        if key not in _LIBS:
            _LIBS[key] = _build_host(name)
    return _LIBS[key]


def _build_host(name: str) -> ctypes.CDLL:
    src = os.path.join(HOST_DIR, name + ".cpp")
    so = _library_path(src, HOST_BUILD_DIR, name)
    if not os.path.exists(so):
        os.makedirs(HOST_BUILD_DIR, exist_ok=True)
        tmp = _tmp_name(so)
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                               "-o", tmp, src], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cpp:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _HOST_SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")


def publish(t):
    """``t`` with the work that made it finished, for a cache that other
    streams read: the sweep's concurrent trials share one dataset, so a
    plan or slot map made on one trial's stream is read on another's.
    Synchronises the current stream where ``t`` is a CUDA tensor, once per
    cache entry. The entry lives as long as its layout, which outlives the
    trials (each trial's stream is synchronised at its end)."""
    import torch

    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
