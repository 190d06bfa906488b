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
import ctypes
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
    },
    "fused_decode": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
        # v_win, lo, out, B, H, r, D, Tmax, W, gs, k_bits, v_bits,
        # n_k_quant, n_k_win, n_v_quant, scale_is_f32, sm_scale, stream
        "kivi_fused_decode": [_P] * 11 + [_I] * 13 + [_F, _P],
    },
    "fused_decode_rows": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, k_win,
        # v_win, counts, lo, out, B, H, r, D, Tmax, W, gs, k_bits,
        # v_bits, scale_is_f32, sm_scale, stream
        "kivi_fused_decode_rows": [_P] * 12 + [_I] * 10 + [_F, _P],
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
        # n_quant, scale_is_f32, stream
        "kivi_qk_dequant": [_P] * 5 + [_I] * 9 + [_P],
        # p, v_codes, v_scale, v_mn, part, out, B, H, r, D, T, gs, bits,
        # n_quant, scale_is_f32, stream
        "kivi_pv_dequant": [_P] * 6 + [_I] * 9 + [_P],
    },
    "flash": {
        # q, k, v, pad, out, B, Hq, Hkv, T, D, sliding_window, sm_scale,
        # stream
        "kivi_flash_prefill": [_P] * 5 + [_I] * 6 + [_F, _P],
    },
    "fp_decode": {
        # q, k, v, pad, lens, out, B, H, r, D, Tmax, length,
        # sliding_window, sm_scale, stream
        "kivi_fp_decode": [_P] * 6 + [_I] * 7 + [_F, _P],
    },
    "trimmed": {
        # q, k_codes, k_scale, k_mn, v_codes, v_scale, v_mn, out, B, H, r,
        # D, Tmax, gs, k_bits, v_bits, n_quant, variant, sm_scale, stream
        "kivi_trimmed": [_P] * 8 + [_I] * 10 + [_F, _P],
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
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        BUILD_SECONDS = time.perf_counter() - t0
        return _LIBS


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


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent one."""
    return None if t is None else t.data_ptr()
