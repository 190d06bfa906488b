"""ctypes bindings for the native safetensors reader: port of
`kivi_tpu/models/native_io.py` over the same C++ source,
`native/safetensors_reader.cpp` (mmap a shard once, hand back pointers
into its tensor data).

The shared object is built at first use with `g++ -O2 -std=c++17
-shared -fPIC` into the port's git-ignored build directory
(`kivi_tpu_torch/_build/`, beside the CUDA libraries of
`kernels/_build.py`), keyed by a hash of the source and the flags.  A
build or load that fails raises, with the compiler's output: unlike the
JAX module, nothing falls back to the Python reader, so a load that
passes has read through the C++ reader (ROADMAP Queue 3).

Tensors come back as torch tensors over the mapping, no copy:
`torch.frombuffer` over a ctypes array at the returned pointer, in the
stored dtype (BF16 as 16-bit words viewed as torch.bfloat16, as
`hf_loader.SafetensorsFile` does).  Each tensor holds a reference to its
shard, so the mapping outlives every tensor that views it.  The pages
are mapped read-only: writing into a view faults.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

SOURCE = (Path(__file__).resolve().parents[2] / "native"
          / "safetensors_reader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

# safetensors dtype names -> torch dtypes
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}

_LIB = None
_LOCK = threading.Lock()


def _target() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join([CXX] + CXX_FLAGS).encode())
    return BUILD_DIR / f"libsafetensors_reader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the reader into the build directory unless it is there;
    returns the shared object's path.  Raises RuntimeError with the
    compiler's output when the build fails."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native reader build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native reader build failed (rc "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The reader's library, built and loaded at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            P, I64 = ctypes.c_void_p, ctypes.c_int64
            lib.str_open.restype = P
            lib.str_open.argtypes = [ctypes.c_char_p]
            lib.str_close.restype = None
            lib.str_close.argtypes = [P]
            lib.str_num_tensors.restype = I64
            lib.str_num_tensors.argtypes = [P]
            lib.str_tensor_name.restype = I64
            lib.str_tensor_name.argtypes = [P, I64, ctypes.c_char_p, I64]
            lib.str_tensor_info.restype = I64
            lib.str_tensor_info.argtypes = [
                P, ctypes.c_char_p, ctypes.c_char_p, I64,
                ctypes.POINTER(I64), ctypes.POINTER(I64),
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(I64)]
            _LIB = lib
        return _LIB


class NativeShard:
    """One mmap'd safetensors shard; `get` gives zero-copy torch views
    into the mapping, each keeping the shard alive."""

    NAME_BUF = 512     # first buffer for a tensor's name, grown on demand

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.str_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"native reader: failed to open or parse {path}")
        self.path = path

    def keys(self) -> List[str]:
        n = self._lib.str_num_tensors(self._h)
        cap = self.NAME_BUF
        buf = ctypes.create_string_buffer(cap)
        out = []
        for i in range(n):
            rc = self._lib.str_tensor_name(self._h, i, buf, cap)
            while rc < 0 and cap < 1 << 20:
                # a name longer than the buffer: grow and retry (never
                # drop a tensor from the listing)
                cap *= 2
                buf = ctypes.create_string_buffer(cap)
                rc = self._lib.str_tensor_name(self._h, i, buf, cap)
            if rc < 0:
                raise ValueError(f"{self.path}: tensor {i}'s name is longer "
                                 f"than {cap} bytes")
            out.append(buf.value.decode())
        return out

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` as a view of the mapped bytes, in its stored
        dtype, on the CPU."""
        dbuf = ctypes.create_string_buffer(16)
        ndim = ctypes.c_int64()
        dims = (ctypes.c_int64 * 8)()
        data = ctypes.c_void_p()
        nbytes = ctypes.c_int64()
        rc = self._lib.str_tensor_info(
            self._h, name.encode(), dbuf, 16, ctypes.byref(ndim), dims,
            ctypes.byref(data), ctypes.byref(nbytes))
        if rc != 0:
            raise KeyError(name)
        dt = dbuf.value.decode()
        if dt not in _DTYPES:
            raise ValueError(f"{self.path}: {name} has unsupported dtype "
                             f"{dt}")
        shape = tuple(dims[i] for i in range(ndim.value))
        if nbytes.value == 0:
            return torch.empty(shape, dtype=_DTYPES[dt])
        raw = (ctypes.c_uint8 * nbytes.value).from_address(data.value)
        raw._shard = self     # the mapping lives while a view does
        return torch.frombuffer(raw, dtype=_DTYPES[dt]).reshape(shape)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.str_close(h)
            self._h = None


def open_shards(paths: List[str]) -> Dict[str, NativeShard]:
    """name -> shard lookup table over several shard files."""
    where: Dict[str, NativeShard] = {}
    for p in paths:
        sh = NativeShard(p)
        for k in sh.keys():
            where[k] = sh
    return where
