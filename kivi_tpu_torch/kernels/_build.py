"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers: a
file builds in seconds).  All sources build in parallel, at first use,
into `kivi_tpu_torch/_build/` (listed in `.gitignore`), keyed by a hash
of the sources so an edited kernel is rebuilt.  A build or launch failure
raises; nothing falls back to the plain versions.

Every C entry point returns `cudaGetLastError()` after its launch; the
wrappers pass the result to `check` and raise when it is not 0.

`LAUNCHES` counts kernel launches by wrapper name.  A wrapper adds one
where it launches its kernel and nowhere else, so a caller that zeroes
it before a run can show which kernels the run went through.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# No --use_fast_math: the quantizer's division must stay IEEE
# round-to-nearest to be bit-equal to the plain version.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures of every entry point, by library.  Pointers and the
# stream are c_void_p: ctypes would otherwise pass them as 32-bit ints.
SIGNATURES = {
    "quant_pack": {
        # x, stride_b, stride_h, stride_t, B, H, T, D, gs, bits,
        # is_key, codes, scale, mn, stream
        "kivi_quantize_pack": [_P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P],
        # x, stride_b, stride_h, stride_t, B, H, T, D, gs, bits, is_key,
        # codes, scale, mn, tmax, stats_bf16, off, offs, pred, stream
        "kivi_quantize_pack_into": [_P, _L, _L, _L] + [_I] * 7
                                   + [_P] * 3 + [_I] * 3 + [_P] * 3,
    },
    "fused_decode": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
        # v_win, lo, out, part_acc, part_ml, tickets, B, H, r, D, Tmax, W,
        # gs, k_bits, v_bits, n_k_quant, n_k_win, n_v_quant, scale_is_f32,
        # split, nsplit, sm_scale, stream
        "kivi_fused_decode": [_P] * 14 + [_I] * 15 + [_F, _P],
    },
    "fused_decode_rows": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
        # v_win, counts, lo, out, part_acc, part_ml, tickets, B, H, r, D,
        # Tmax, W, gs, k_bits, v_bits, scale_is_f32, split, nsplit,
        # t_bound, sm_scale, stream
        "kivi_fused_decode_rows": [_P] * 15 + [_I] * 13 + [_F, _P],
    },
    "flash_extend": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
        # v_win, k_new, v_new, pad, out, B, H, R, T1, D, Tmax, W, gs,
        # k_bits, v_bits, n_k_quant, n_k_win, n_v_quant, sliding_window,
        # scale_is_f32, sm_scale, stream
        "kivi_flash_extend": [_P] * 13 + [_I] * 15 + [_F, _P],
    },
    "flash_extend_qhist": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, v_win, pad,
        # part_acc, part_m, part_l, acc, m, l, B, H, R, T1, D, Tmax, W, gs,
        # k_bits, v_bits, n_k_quant, n_v_quant, seq_len, sliding_window,
        # scale_is_f32, sm_scale, stream
        "kivi_flash_extend_qhist": [_P] * 15 + [_I] * 15 + [_F, _P],
    },
    "qk_pv": {
        # q, k_codes, k_scale, k_mn, out, B, H, r, D, T, gs, bits,
        # n_quant, scale_is_f32, split, stream
        "kivi_qk_dequant": [_P] * 5 + [_I] * 10 + [_P],
        # p, v_codes, v_scale, v_mn, out, part_acc, tickets, B, H, r, D, T,
        # gs, bits, n_quant, scale_is_f32, split, nsplit, stream
        "kivi_pv_dequant": [_P] * 7 + [_I] * 11 + [_P],
    },
    "flash": {
        # q, k, v, pad, out, B, Hq, Hkv, T, D, sliding_window, sm_scale,
        # stream
        "kivi_flash_prefill": [_P] * 5 + [_I] * 6 + [_F, _P],
        # a, b, out, n, mode, stream
        "kivi_wgmma_tile": [_P] * 3 + [_I] * 2 + [_P],
    },
    "fp_decode": {
        # q, k, v, pad, lens, out, part_acc, part_ml, tickets, B, H, r, D,
        # Tmax, length, t_bound, sliding_window, sm_scale, stream
        "kivi_fp_decode": [_P] * 9 + [_I] * 8 + [_F, _P],
    },
    "trimmed": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, out,
        # part_acc, part_ml, tickets, B, H, r, D, Tmax, gs, k_bits, v_bits,
        # n_quant, variant, split, nsplit, sm_scale, stream
        "kivi_trimmed": [_P] * 11 + [_I] * 12 + [_F, _P],
    },
}

_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOG: dict = {}      # library name -> nvcc's output (ptxas -v lines)
BUILD_SECONDS: float = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every library that is not built yet, one nvcc per source,
    all started together; load all of them.  Returns {name: CDLL}."""
    global BUILD_SECONDS
    with _LOCK:
        if len(_LIBS) == len(SIGNATURES):
            return _LIBS
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SIGNATURES:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc rc {proc.returncode})\n"
                              f"{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for name in SIGNATURES:
            _LIBS[name] = _load(_target(name), name)
        BUILD_SECONDS = time.perf_counter() - t0
        return _LIBS


def _load(path, name: str):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_probes(name: str, variants: dict) -> dict:
    """{variant: CDLL}: library `name` built once per variant, a list of
    extra nvcc flags (-D switches; [] is the library itself), the probe
    builds started together while the libraries build.  For profilers
    that time a kernel's phases or its compile-time choices apart."""
    base = _target(name)
    procs, libs, paths = {}, {}, {}
    for v, flags in variants.items():
        if not flags:
            continue
        tag = hashlib.sha1(" ".join(flags).encode()).hexdigest()[:8]
        paths[v] = out = base.with_name(f"{base.stem}-probe-{tag}.so")
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o",
                   str(out), str(CSRC / f"{name}.cu")]
            procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    lib = library(name)
    logs = {v: proc.communicate()[0] for v, proc in procs.items()}
    for v, proc in procs.items():
        BUILD_LOG[f"{name} {v}"] = logs[v]
        if proc.returncode:
            raise RuntimeError(f"probe build {v} of {name} failed:\n"
                               f"{logs[v]}")
    for v in variants:
        libs[v] = _load(paths[v], name) if v in paths else lib
    return libs


@contextlib.contextmanager
def through(name: str, lib):
    """The wrappers of library `name` launch from `lib` inside the
    block."""
    old = _LIBS[name]
    _LIBS[name] = lib
    try:
        yield
    finally:
        _LIBS[name] = old


@functools.lru_cache(maxsize=16)
def workspace(device, BH: int, nsplit: int, r: int, D: int):
    """The split kernels' per-split partials (acc (BH * nsplit * r * D)
    and (m, l) pairs, f32) and per-head tickets (int32 zeros; every
    launch leaves them zero), for at most `nsplit` splits: allocated once
    per device and shape, reused by every call on the one stream."""
    import torch
    n = BH * nsplit * r
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(n * D, **f32), torch.empty(2 * n, **f32),
            torch.zeros(BH, dtype=torch.int32, device=device))


def library(name: str):
    return build_all()[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_tensors(name: str, device, spec: dict) -> None:
    """Raise unless every tensor of spec {key: (tensor, shape, dtype)}
    is contiguous, on `device`, of that shape and dtype."""
    for key, (t, shape, dt) in spec.items():
        if (t.device != device or tuple(t.shape) != tuple(shape)
                or t.dtype != dt or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {key} must be a contiguous {dt} tensor of shape "
                f"{tuple(shape)} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def check_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the
    kernels that stage with 16-byte cp.async copies)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def check_t_bound(name: str, t_bound, Tmax: int, split: int) -> int:
    """A split decode kernel's grid end: Tmax without a static fill
    bound (None), else t_bound, which must be Tmax or a multiple of the
    kernel's split below it."""
    if t_bound is None:
        return Tmax
    t_bound = int(t_bound)
    if not (t_bound == Tmax or (0 < t_bound < Tmax
                                and t_bound % split == 0)):
        raise ValueError(f"{name}: t_bound={t_bound} must be Tmax={Tmax} "
                         f"or a multiple of {split} below it")
    return t_bound


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent one."""
    return None if t is None else t.data_ptr()
