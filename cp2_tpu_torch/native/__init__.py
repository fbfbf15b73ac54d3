"""ctypes binding for the native C++ decode/resize loader.

A copy of ``cp2_tpu/native/__init__.py`` and its ``loader.cpp``.  Builds
``libcp2loader.so`` on first use (g++, links libjpeg/libpng) into the
port's build directory and exposes ``NativePretrainLoader`` with the same
epoch-iterator contract as the Python ``HostDataLoader``; callers fall back
to the Python path when the toolchain or libraries are unavailable
(``native_available()``).  A failed build is remembered for the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_THIS_DIR, "loader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_THIS_DIR), "_build")


def _arch_tag() -> str:
    """Microarchitecture cache key for the -march=native build.

    The .so is compiled with -march=native; a library built on one host
    and reused from shared storage on an older CPU dies with SIGILL, so
    the CPU model participates in the cache filename.
    """
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "Model")):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    h = hashlib.sha1(model.encode()).hexdigest()[:8]
    return f"{platform.machine()}_{h}"


_LIB = os.path.join(_BUILD_DIR, f"libcp2loader_{_arch_tag()}.so")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB,
        "-ljpeg", "-lpng", "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        _build_error = _build()
        if _build_error:
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        _build_error = str(e)
        return None
    lib.cp2_loader_create.restype = ctypes.c_void_p
    lib.cp2_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.cp2_loader_create_pairs.restype = ctypes.c_void_p
    lib.cp2_loader_create_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.cp2_loader_set_shard.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.cp2_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cp2_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cp2_loader_next.restype = ctypes.c_int
    lib.cp2_loader_next_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ]
    lib.cp2_loader_next_pair.restype = ctypes.c_int
    lib.cp2_loader_len.argtypes = [ctypes.c_void_p]
    lib.cp2_loader_len.restype = ctypes.c_int
    lib.cp2_loader_cache_attach.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.cp2_loader_cache_attach.restype = ctypes.c_int
    lib.cp2_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def default_cache_path(cache_dir: str, files: Sequence[str],
                       base_hw: Tuple[int, int], mode: str) -> str:
    """Stable cache filename for a (file list, geometry, mode) combination.

    Content freshness (sizes/mtimes) is validated natively at attach time;
    this name only needs to distinguish different datasets sharing a dir.
    """
    h = hashlib.sha1()
    h.update(f"{mode}:{base_hw[0]}x{base_hw[1]}".encode())
    for f in files:
        h.update(os.fsencode(f) + b"\0")
    return os.path.join(cache_dir, f"rawframes_{h.hexdigest()[:16]}.rawc")


class NativePretrainLoader:
    """Epoch-iterating uint8 frame loader backed by the C++ worker pool.

    ``cache_path`` enables the raw-frame cache: the deterministic
    decode+resize intermediate is computed once (built in parallel on first
    use, invalidated when any source file changes) and mmap'd thereafter,
    turning the per-epoch host cost from decode-bound into memcpy-bound.
    ``cache_status``: 2 = existing cache mapped, 1 = built now, 0 = live
    decode (cache unavailable or not requested).
    """

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        base_hw: Tuple[int, int],
        *,
        threads: int = 4,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        shard: Tuple[int, int] = (0, 1),
        cache_path: Optional[str] = None,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self.files = [os.fsencode(f) for f in files]
        self.batch_size = batch_size
        self.base_hw = base_hw
        arr = (ctypes.c_char_p * len(self.files))(*self.files)
        self._handle = lib.cp2_loader_create(
            arr, len(self.files), batch_size, base_hw[0], base_hw[1],
            threads, seed, int(shuffle), int(drop_last),
        )
        if shard != (0, 1):
            lib.cp2_loader_set_shard(self._handle, shard[0], shard[1])
        self.cache_status = 0
        if cache_path:
            self.cache_status = lib.cp2_loader_cache_attach(
                self._handle, os.fsencode(cache_path), 1
            )
        self._buf = np.empty(
            (batch_size, base_hw[0], base_hw[1], 3), dtype=np.uint8
        )

    def __len__(self) -> int:
        return self._lib.cp2_loader_len(self._handle)

    def epoch_iterator(self, epoch: int = 0) -> Iterator[dict]:
        self._lib.cp2_loader_start_epoch(self._handle, epoch)
        while True:
            valid = self._lib.cp2_loader_next(
                self._handle, self._buf.ctypes.data_as(ctypes.c_char_p)
            )
            if not valid:
                return
            yield {
                "image": self._buf.copy(),
                "valid": np.arange(self.batch_size) < valid,
            }

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.cp2_loader_destroy(self._handle)
        except Exception:
            pass


class NativePairLoader:
    """Paired (image, mask/region-map) loader backed by the C++ pool.

    Two geometry modes mirroring the Python sources:

    * ``mode="region"`` — both streams resized to ``base_hw`` (image
      bilinear, map nearest); REGION_ID pretrain input (reference
      loader.py:75-83 SAM_Masks pairing).
    * ``mode="crop"`` — SmallestMaxSize to ``image_size`` then one shared
      random (or center) crop; the finetune (image, mask) pipeline
      (reference finetune_dataset.py:89-117).  Mask binarization for
      ``num_classes == 2`` happens here, like ``SegmentationDataSource``.
    """

    _MODES = {"region": 1, "crop": 2}

    def __init__(
        self,
        pairs: Sequence[Tuple[str, str]],
        batch_size: int,
        base_hw: Tuple[int, int],
        *,
        mode: str = "crop",
        random_crop: bool = True,
        num_classes: int = 0,
        threads: int = 4,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        shard: Tuple[int, int] = (0, 1),
        cache_path: Optional[str] = None,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if mode == "crop" and base_hw[0] != base_hw[1]:
            raise ValueError("crop mode requires a square target")
        self._lib = lib
        self.batch_size = batch_size
        self.base_hw = base_hw
        self.num_classes = num_classes
        imgs = [os.fsencode(i) for i, _ in pairs]
        auxs = [os.fsencode(a) for _, a in pairs]
        img_arr = (ctypes.c_char_p * len(imgs))(*imgs)
        aux_arr = (ctypes.c_char_p * len(auxs))(*auxs)
        self._handle = lib.cp2_loader_create_pairs(
            img_arr, aux_arr, len(imgs), batch_size, base_hw[0], base_hw[1],
            threads, seed, int(shuffle), int(drop_last),
            self._MODES[mode], int(random_crop),
        )
        if shard != (0, 1):
            lib.cp2_loader_set_shard(self._handle, shard[0], shard[1])
        # raw-frame cache (see NativePretrainLoader): for mode="crop" the
        # cached object is the SmallestMaxSize intermediate — the shared
        # random/center crop is still applied per epoch at read time
        self.cache_status = 0
        if cache_path:
            self.cache_status = lib.cp2_loader_cache_attach(
                self._handle, os.fsencode(cache_path), 1
            )
        self._img = np.empty((batch_size, base_hw[0], base_hw[1], 3), np.uint8)
        self._aux = np.empty((batch_size, base_hw[0], base_hw[1]), np.int32)

    def __len__(self) -> int:
        return self._lib.cp2_loader_len(self._handle)

    def epoch_iterator(self, epoch: int = 0) -> Iterator[dict]:
        self._lib.cp2_loader_start_epoch(self._handle, epoch)
        while True:
            valid = self._lib.cp2_loader_next_pair(
                self._handle,
                self._img.ctypes.data_as(ctypes.c_char_p),
                self._aux.ctypes.data_as(ctypes.c_void_p),
            )
            if not valid:
                return
            mask = self._aux
            if self.num_classes == 2:
                mask = (mask > 0).astype(np.int32)
            else:
                mask = mask.copy()
            # per-row "valid" mask: rows past the count are pad repeats of
            # the final sample (drop_last=false) and must be excluded from
            # eval.  A mask (not a count) so multi-host global assembly
            # keeps each host's pad rows addressable.
            yield {
                "image": self._img.copy(),
                "mask": mask,
                "valid": np.arange(self.batch_size) < valid,
            }

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.cp2_loader_destroy(self._handle)
        except Exception:
            pass
