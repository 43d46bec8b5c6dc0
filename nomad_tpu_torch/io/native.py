"""ctypes bindings to the repository's native C++ ingest library
(``native/nomad_native.cpp`` + ``native/flac_decoder.cpp``): WAV and FLAC
decode, stereo fold, torchaudio-default resampling and zero padding into
a batch, in a C++ thread pool that runs without the interpreter lock.

The counterpart of ``nomad_tpu.io.native``. The library is compiled from
those two sources, which this module reads and never writes, at first
use with ``g++ -O3 -march=native -fPIC -std=c++17 -shared -pthread`` into
``libnomad_native-<hash>.so`` in the build directory
(``utils/cache.py::build_dir``: ``build/nomad_tpu_torch`` under the checkout
unless ``NOMAD_TPU_TORCH_CACHE_DIR`` names another).
The hash covers the sources, the flags and the host's CPU-flag signature:
``-march=native`` code can fault on another CPU, so a checkout that moves
to another host builds again. One process builds at a time (a file lock);
the others wait and load its result.

Each entry returns None when the library is unavailable (no compiler, a
failed build: ``build_error()`` says why); the scoring engine then takes
the Python decoder, which gives the same samples.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..utils.cache import build_dir
from .resample import sinc_resample_kernel

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "nomad_native.cpp", ROOT / "native" / "flac_decoder.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread")
ABI_VERSION = 1
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False

_P = ctypes.POINTER
_i32, _i64, _f32, _i16 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_int16


def cpu_signature() -> str:
    """Hash of the host's CPU feature flags (``/proc/cpuinfo``)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(flags.encode()).hexdigest()[:16]
    except OSError:
        pass
    return "unknown"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(cpu_signature().encode())
    return build_dir() / f"libnomad_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the library into ``so`` unless it is there; raises
    ``RuntimeError`` with the compiler's output on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) to build the native ingest library")
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "libnomad_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.is_file():
            return
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)


def _declare(lib: ctypes.CDLL) -> None:
    lib.nomad_native_abi_version.restype = ctypes.c_int
    lib.nomad_native_abi_version.argtypes = []
    lib.nomad_decode_wav.restype = ctypes.c_int
    lib.nomad_decode_wav.argtypes = [ctypes.c_char_p, _P(_f32), _i64, _P(_i64), _P(_i32)]
    lib.nomad_wav_info.restype = ctypes.c_int
    lib.nomad_wav_info.argtypes = [ctypes.c_char_p, _P(_i32), _P(_i64), _P(_i32)]
    lib.nomad_probe.restype = ctypes.c_int
    lib.nomad_probe.argtypes = [ctypes.c_char_p, _P(_i32), _P(_i64), _P(_i32), _P(_i32),
                                _P(_i32), _P(_i32)]
    lib.nomad_load_batch_i16.restype = ctypes.c_int
    lib.nomad_load_batch_i16.argtypes = [_P(ctypes.c_char_p), _i64, _P(_i16), _i64, _P(_i64),
                                         _P(_i32), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for name, sample in (("nomad_load_batch", _f32), ("nomad_load_batch_q16", _i16)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P(ctypes.c_char_p), _i64, _P(sample), _i64, _P(_i64), _P(_i32),
                       ctypes.c_int, ctypes.c_int, _P(_f32), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.nomad_pack_i16.restype = _i64
    lib.nomad_pack_i16.argtypes = [_P(_i16), _i64, _P(ctypes.c_uint32), _i64, _P(_i32),
                                   _P(_i32), _P(_i32), ctypes.c_int]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when it cannot be."""
    global _lib, _error, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                so = library_path()
                _build(so)
                lib = ctypes.CDLL(str(so))
                _declare(lib)
                if lib.nomad_native_abi_version() != ABI_VERSION:
                    raise RuntimeError(f"{so}: ABI {lib.nomad_native_abi_version()}, "
                                       f"expected {ABI_VERSION}")
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not tried)."""
    return _error


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(16, os.cpu_count() or 4)


def native_wav_info(path: str):
    """(sample rate, frames, channels) of a WAV or FLAC file, or None."""
    lib = get_lib()
    if lib is None:
        return None
    sr, frames, ch = _i32(), _i64(), _i32()
    if lib.nomad_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(frames),
                          ctypes.byref(ch)) != 0:
        return None
    return int(sr.value), int(frames.value), int(ch.value)


def native_decode(path: str, max_samples: int = 1 << 26):
    """Decode one file to mono float32 (stereo folded, no resample):
    (samples, sample rate), or None on failure."""
    lib = get_lib()
    info = native_wav_info(path) if lib is not None else None
    if info is None:
        return None
    out = np.empty(min(info[1], max_samples), np.float32)
    out_len, got_sr = _i64(), _i32()
    rc = lib.nomad_decode_wav(path.encode(), out.ctypes.data_as(_P(_f32)), out.shape[0],
                              ctypes.byref(out_len), ctypes.byref(got_sr))
    if rc != 0:
        return None
    return out[: out_len.value], int(got_sr.value)


def native_probe(path: str):
    """(sample rate, frames, channels, bits, is_float, is_flac), or None."""
    lib = get_lib()
    if lib is None:
        return None
    sr, frames, ch, bits, is_float, is_flac = _i32(), _i64(), _i32(), _i32(), _i32(), _i32()
    rc = lib.nomad_probe(path.encode(), ctypes.byref(sr), ctypes.byref(frames),
                         ctypes.byref(ch), ctypes.byref(bits), ctypes.byref(is_float),
                         ctypes.byref(is_flac))
    if rc != 0:
        return None
    return (int(sr.value), int(frames.value), int(ch.value), int(bits.value),
            bool(is_float.value), bool(is_flac.value))


def _outputs(n: int, pad_len: int, dtype, out, lengths):
    """The batch and lengths buffers the loaders write: the caller's (a
    C-contiguous [n, pad_len] array of ``dtype`` and an [n] int64 array,
    e.g. views of pinned host tensors) or new ones."""
    if out is None:
        out = np.empty((n, pad_len), dtype)
    if lengths is None:
        lengths = np.empty((n,), np.int64)
    if (out.shape != (n, pad_len) or out.dtype != dtype or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous {np.dtype(dtype).name} array "
                         f"of shape {(n, pad_len)}, got {out.dtype} {out.shape}")
    if lengths.shape != (n,) or lengths.dtype != np.int64 or not lengths.flags.c_contiguous:
        raise ValueError(f"lengths must be a C-contiguous int64 array of shape {(n,)}")
    return out, lengths


def native_load_batch_i16(paths: Sequence[str], pad_len: int, target_sr: int = 16000,
                          trim_sec: int = 0, num_threads: int = 0, out=None, lengths=None):
    """Mono PCM16 files at ``target_sr`` -> their raw int16 samples (the
    first ``trim_sec`` seconds when it is not 0), zero-padded into [n,
    pad_len] (``out``), with lengths; any other file gets a non-zero error
    flag and a zero row. Returns (batch, lengths, err_flags) or None when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    batch, lengths = _outputs(n, pad_len, np.int16, out, lengths)
    errs = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.nomad_load_batch_i16(c_paths, n, batch.ctypes.data_as(_P(_i16)), pad_len,
                             lengths.ctypes.data_as(_P(_i64)), errs.ctypes.data_as(_P(_i32)),
                             target_sr, trim_sec, _threads(num_threads))
    return batch, lengths, errs


def native_load_batch(paths: Sequence[str], pad_len: int, target_sr: int = 16000,
                      trim_sec: int = 0, expect_sr: int = 0, num_threads: int = 0,
                      quantize_i16: bool = False, out=None, lengths=None):
    """Decode, fold to mono, resample (files at ``expect_sr``; files at
    ``target_sr`` pass through), trim to ``trim_sec`` seconds when it is
    not 0 and zero-pad n files into a float32 [n, pad_len] batch (``out``).
    Files at any other rate get a non-zero error flag for the caller to
    retry in Python. ``quantize_i16`` writes an int16 batch instead,
    rounded to the PCM16 grid in C++ (to nearest, ties to even, clamped): half
    the bytes to the device, at most 1/65,536 from the float samples.
    Returns (batch, lengths, err_flags) or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    sample, ptr = (np.int16, _i16) if quantize_i16 else (np.float32, _f32)
    batch, lengths = _outputs(n, pad_len, sample, out, lengths)
    errs = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    kern_ptr, klen, width, og, ng = None, 0, 0, 0, 0
    if expect_sr and expect_sr != target_sr:
        kernels, width, og, ng = sinc_resample_kernel(expect_sr, target_sr)
        kernels = np.ascontiguousarray(kernels, np.float32)  # kept alive for the call
        klen = kernels.shape[1]
        kern_ptr = kernels.ctypes.data_as(_P(_f32))
    fn = lib.nomad_load_batch_q16 if quantize_i16 else lib.nomad_load_batch
    fn(c_paths, n, batch.ctypes.data_as(_P(ptr)), pad_len, lengths.ctypes.data_as(_P(_i64)),
       errs.ctypes.data_as(_P(_i32)), target_sr, trim_sec, kern_ptr, klen, width, og, ng,
       expect_sr, _threads(num_threads))
    return batch, lengths, errs


def native_pack_i16(batch, num_threads: int = 8):
    """The wire codec's packer in C++ (``ops/wirecodec.py`` has the
    format): a C-contiguous int16 array whose size is a multiple of 1,024
    -> (packed uint32[total], widths, offsets, firsts), each int32 per
    1,024-sample block; None when the library is unavailable or the size
    does not divide."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(batch, dtype=np.int16)
    if arr.size % 1024:
        return None
    nb = arr.size // 1024
    cap = nb * (17 * 1024 // 32) + 2  # every block at the widest 17 bit planes
    packed = np.empty(cap, np.uint32)
    widths, offsets, firsts = (np.empty(nb, np.int32) for _ in range(3))
    total = lib.nomad_pack_i16(arr.ctypes.data_as(_P(_i16)), nb,
                               packed.ctypes.data_as(_P(ctypes.c_uint32)), cap,
                               widths.ctypes.data_as(_P(_i32)), offsets.ctypes.data_as(_P(_i32)),
                               firsts.ctypes.data_as(_P(_i32)), num_threads)
    if total < 0:
        return None
    return packed[:total], widths, offsets, firsts
