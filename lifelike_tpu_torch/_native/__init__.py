"""Native (C++) host code of the port, loaded with ctypes: the mocap clip
parser (clip_parser.cpp).

The library is built with g++ at first use into lifelike_tpu_torch/build/,
named by a hash of its source and flags so an edited source is rebuilt.
`parse_clip_file` returns None when the library cannot be built or loaded,
or when a file does not fit the parser's restricted grammar; the caller
(motion.motion_lib.load_clips) then reads that file with the json module.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "clip_parser.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libclip_parser_{h.hexdigest()[:16]}.so")


def _build(path) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if missing) and load the native library; None on failure."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.clip_parse_file.restype = ctypes.c_int
        lib.clip_parse_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return _lib


def parse_clip_file(path: str) -> Optional[Tuple[np.ndarray, float]]:
    """Parse one retargeted-clip JSON file natively: (frames (N, 19)
    float32, frame duration), or None (no library, or a file outside the
    restricted grammar)."""
    lib = load_library()
    if lib is None:
        return None
    cpath = os.fsencode(path)
    fd = ctypes.c_double()
    n = ctypes.c_long()
    rc = lib.clip_parse_file(cpath, None, 0, ctypes.byref(fd), ctypes.byref(n))
    if rc != 0 or n.value <= 0 or n.value % 19 != 0:
        return None
    out = np.empty(n.value, dtype=np.float32)
    rc = lib.clip_parse_file(cpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n.value,
                             ctypes.byref(fd), ctypes.byref(n))
    if rc != 0:
        return None
    return out.reshape(-1, 19), float(fd.value)
