"""ctypes binding of the repo's native PNG loader (native/dataset_loader.cpp).

Counterpart of ``badslam_tpu/io/native_loader.py``: libpng decode of one
file (`read_png`) and a background prefetch ring over a path list
(`NativePrefetchLoader`), through the plain C interface of
``native/libbadslam_loader.so`` (built by ``native/build.sh``).

The library links libpng and zlib. Where it is missing, or the dynamic
loader cannot open it (a machine without libpng), `available()` is False
and callers decode with ``io/png.py`` instead (`decoder_name` says which).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libbadslam_loader.so",
)


class _BadslamPng(ctypes.Structure):
    _fields_ = [
        ("handle", ctypes.c_void_p),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("bit_depth", ctypes.c_int),
    ]


_lib = None
_load_error: Optional[str] = None


def _load_lib():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _load_error = f"{_LIB_PATH} not built (native/build.sh)"
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:  # e.g. libpng16.so.16 not installed
        _load_error = str(e)
        return None
    lib.badslam_png_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_BadslamPng)]
    lib.badslam_png_open.restype = ctypes.c_int
    lib.badslam_png_data.argtypes = [ctypes.POINTER(_BadslamPng), ctypes.c_void_p]
    lib.badslam_png_data.restype = None
    lib.badslam_png_close.argtypes = [ctypes.POINTER(_BadslamPng)]
    lib.badslam_png_close.restype = None
    lib.badslam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    lib.badslam_loader_create.restype = ctypes.c_void_p
    lib.badslam_loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_BadslamPng)]
    lib.badslam_loader_get.restype = ctypes.c_int
    lib.badslam_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.badslam_loader_destroy.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load_lib() is not None


def decoder_name() -> str:
    """Which PNG decoder the port's readers use in this process."""
    if available():
        return "libpng (native/libbadslam_loader.so)"
    return f"io/png.py (zlib + numpy; native loader unavailable: {_load_error})"


def _png_to_numpy(lib, png: _BadslamPng) -> np.ndarray:
    dtype = np.uint16 if png.bit_depth == 16 else np.uint8
    shape = ((png.height, png.width) if png.channels == 1
             else (png.height, png.width, png.channels))
    buf = np.empty(shape, dtype)
    lib.badslam_png_data(ctypes.byref(png), buf.ctypes.data_as(ctypes.c_void_p))
    lib.badslam_png_close(ctypes.byref(png))
    return buf


def read_png(path: str) -> Optional[np.ndarray]:
    """Decode one PNG (u16 gray, or u8 RGB with alpha stripped and 16-bit
    color cut to 8) with libpng; None when the library is unavailable or
    the file cannot be opened or decoded (also a file cut short)."""
    lib = _load_lib()
    if lib is None:
        return None
    png = _BadslamPng()
    if not lib.badslam_png_open(path.encode(), ctypes.byref(png)):
        return None
    return _png_to_numpy(lib, png)


class NativePrefetchLoader:
    """Background-prefetching PNG loader over an ordered path list."""

    _handle = None

    def __init__(self, paths: List[str], ring: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_load_error}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.badslam_loader_create(arr, len(paths), ring)
        self._len = len(paths)

    def __len__(self) -> int:
        return self._len

    def get(self, index: int) -> Optional[np.ndarray]:
        if not 0 <= index < self._len:  # the C side would wait forever
            raise IndexError(f"frame {index} outside [0, {self._len})")
        png = _BadslamPng()
        if not self._lib.badslam_loader_get(self._handle, index, ctypes.byref(png)):
            return None
        return _png_to_numpy(self._lib, png)

    def close(self) -> None:
        if self._handle:
            self._lib.badslam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
