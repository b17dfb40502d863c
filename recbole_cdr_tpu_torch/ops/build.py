"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, which is loaded with
ctypes. All sources compile in parallel (one ``nvcc`` process each) on first
use, into ``build/kernels/`` beside the package (override with the
``RECBOLE_CDR_TORCH_BUILD_DIR`` environment variable). A library's file name
carries a hash of its source, the shared headers of ``csrc/`` (``*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged one
is reused.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("gather_dot", "neg_sampler", "shuffle", "masked_topk", "streaming_topk",
           "sparse_adam", "graph_layer", "rank_sum", "natr_attention", "rating_vector",
           "benchmark_topk", "conet_tower", "deepapf_attention", "row_groups")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the operand types of the kernels that take more than float32, and the
#: type code each C entry takes for them (0 float32, 1 bfloat16, 2 float16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the 16-bit types among them
FLOAT16 = (torch.bfloat16, torch.float16)


def wide(dtype):
    """The plain versions' working type: float32 for 16-bit operands, else
    the operands' own (float64 in the card tests' exact references)."""
    return torch.promote_types(dtype, torch.float32)


def rounding(dtype):
    """A working-type tensor rounded to nearest in ``dtype`` with its
    gradient passed through unchanged (the kernels' backward): the identity
    unless ``dtype`` is 16-bit. The plain 16-bit versions round with it where
    the kernels round."""
    if wide(dtype) == dtype:
        return lambda t: t
    return lambda t: t + (t.to(dtype).to(t.dtype) - t).detach()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: name -> (symbol, argtypes)
_SIGNATURES = {
    "gather_dot": {
        "gather_dot_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "gather_dot_backward": [_P] * 5 + [_I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                                           _P],
    },
    "neg_sampler": {
        "neg_sampler": [_P, _P, _I, _P, _I, _P, ctypes.c_longlong, ctypes.c_uint,
                        _I, _I, _I, _P, _P],
        "neg_sampler_popularity": [_P, _P, _P, _I, _P, _I, _P, ctypes.c_longlong, _P, _P, _P,
                                   ctypes.c_uint, _P, _P],
    },
    "shuffle": {"swap_or_not": [_P, _P, _I, _I, _I, _P, _P, _I, _P]},
    "masked_topk": {"masked_topk": [_P, _I, _I, _P, _P, _I] + [_I] * 5 + [_P, _P],
                    "candidate_topk": [_P, _I, _I, _P, _I] + [_I] * 5 + [_P, _P]},
    "streaming_topk": {
        "streaming_topk": [_P, _P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                           _P],
        "streaming_topk_splits": [_I, _I, _I, _I],
        "streaming_topk_16": [_P, _P, _I, _I, _I, _P, _P, _I, _P] + [_I] * 7
                             + [_P] * 4 + [_I, _I, _P],
        "streaming_topk_merge": [_P, _P, _I, _I, _I, _P, _P, _P],
    },
    "sparse_adam": {
        "sparse_adam": [_P] * 4 + [_I, _I, _P] + [_F] * 6 + [_I, _P],
    },
    "graph_layer": {
        "graph_layer_forward": [_P, _I, _I] + [_P] * 7 + [_F, _P, _P, _P, _I, _I, _I, _P],
        "graph_layer_backward": [_P, _I, _I] + [_P] * 8 + [_F] + [_P] * 4 + [_I, _I, _I, _P],
    },
    "rank_sum": {"rank_sum": [_P, _I, _I, _P, _P, _P, _P] + [_I] * 5 + [_P, _P],
                 "rank_sum_candidates": [_P, _I, _I, _P, _P] + [_I] * 4 + [_P, _P]},
    "natr_attention": {
        "natr_attention_forward": [_P, _I, _P, _P, _I, _I, _P, _P] + [_P] * 6 + [_P, _I]
                                  + [_P] * 5 + [_I, _P],
        "natr_anchor_table": [_P] * 9 + [_I] * 3 + [_P, _I, _P],
        "natr_pair_grid": [_P] * 5 + [_I] * 4 + [_P, _I, _P],
        "natr_attention_backward_blocks": [_I, _I, _I, _I],
        "natr_attention_backward": [_P, _P, _I, _I, _P, _I] + [_P] * 14 + [_I, _P, _I, _P],
    },
    "rating_vector": {
        "rating_vector_plan": [_P, _I, _I] + [_P] * 12,
        "rating_vector_forward": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I]
                                 + [_P] * 8,
        "rating_vector_backward": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I]
                                  + [_P] * 7 + [_I, _P, _P],
    },
    "benchmark_topk": {"benchmark_topk": [_P] * 4 + [_I] * 5 + [_P] * 6},
    "conet_tower": {"conet_tower": [_P, _P, _P, _I, _I, _P] + [_I] * 7 + [_P, _I, _P]},
    "deepapf_attention": {
        "deepapf_forward": [_P, _P, _I, _I, _I] + [_P] * 4 + [_I, _P, _I, _P],
        "deepapf_grid": [_P] * 5 + [_I] * 4 + [_P] * 4 + [_I, _P, _I, _P],
        "deepapf_backward_blocks": [_I, _I, _I],
        "deepapf_backward": [_P, _P] + [_I] * 5 + [_P] * 4 + [_I] + [_P] * 4 + [_I, _I, _P],
        "deepapf_backward_tables": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    },
    "row_groups": {
        "row_groups_plan": [_I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P],
        "row_sum": [_P] + [_I] * 4 + [_P] * 3,
    },
}

_lock = threading.Lock()
_libs = {}
#: ptxas resource report (registers, shared memory, spills) per source
build_logs = {}


def build_dir() -> str:
    default = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "kernels")
    return os.environ.get("RECBOLE_CDR_TORCH_BUILD_DIR", default)


def _nvcc() -> str:
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every missing library in parallel and load all of them.
    Returns the seconds spent (0 when everything was built already)."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return 0.0
        t0 = time.perf_counter()
        os.makedirs(build_dir(), exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in SOURCES:
            path = _lib_path(name)
            if os.path.isfile(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[name] = (path, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for name, (path, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in SOURCES:
            lib = ctypes.CDLL(_lib_path(name))
            for symbol, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return time.perf_counter() - t0


def build_variants(source: str, entry: str, texts: dict, subdir: str) -> dict:
    """{name: the ``entry`` function of each variant text of
    ``csrc/{source}.cu``}, every variant compiled at once into
    ``build_dir()/subdir``: for probes that time a kernel beside cuts of its
    source."""
    out_dir = os.path.join(build_dir(), subdir)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = os.path.join(out_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant of {source}.cu:\n{out}")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, name + ".so")), entry)
        fn.argtypes = _SIGNATURES[source][entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")


def stream_handle(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int:
    torch's raw accessor where the build has it (it makes no ``Stream``
    object, a few microseconds of host time a kernel call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(t.device).cuda_stream
    return raw(t.device.index)
