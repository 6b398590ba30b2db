"""Python bindings for the native C++ batch sampler (batch assembly off the
interpreter lock).

Counterpart of hierarchicalprobabilistic3dhuman_tpu/data/native_loader.py
(which imports no JAX; copied here). The sampler memory-maps fixed-record
binary tensor stores (one per field: poses / textures / pre-resized
backgrounds), assembles batches on C++ worker threads, and hands them to
Python as numpy arrays, so host input work overlaps the card's steps
without DataLoader worker processes. The store format is the JAX package's
(a raw .bin file and an np.save'd dict in .meta.npy): each package reads
the other's stores.

Differences from the JAX package's copy:
  * the library is compiled from the port's csrc/batch_sampler.cpp into
    build/hp3d_torch_native/ (rebuilt when the source is newer), never into
    a package directory;
  * stores may hold different record counts (see csrc/batch_sampler.cpp);
    an epoch is the first store's count, the poses' in NativeTrainLoader;
  * a failed build or sampler call raises; nothing falls back to the Python
    DataLoader;
  * the batches come in one order for a seed and thread count, however the
    threads run (see csrc/batch_sampler.cpp), so the ranks of a mesh take
    the same batches with several threads each.
"""

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

from hierarchicalprobabilistic3dhuman_torch.runtime.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG_DIR, "csrc", "batch_sampler.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hp3d_torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libbatch_sampler.so")


def build_sampler():
    """Compile csrc/batch_sampler.cpp with g++ into
    build/hp3d_torch_native/libbatch_sampler.so (skipped while the library
    is newer than the source). The library is written under a temporary
    name and moved into place, so processes that build at once do not see
    each other's half-written files.

    :return: the library path
    """
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC_PATH)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
         SRC_PATH, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on csrc/batch_sampler.cpp:\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_sampler())
    lib.bs_create.restype = ctypes.c_void_p
    lib.bs_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_uint64, ctypes.c_int]
    lib.bs_add_store.restype = ctypes.c_int
    lib.bs_add_store.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.bs_start.restype = ctypes.c_int
    lib.bs_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bs_batch_bytes.restype = ctypes.c_int64
    lib.bs_batch_bytes.argtypes = [ctypes.c_void_p]
    lib.bs_next.restype = ctypes.c_int
    lib.bs_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.bs_destroy.restype = None
    lib.bs_destroy.argtypes = [ctypes.c_void_p]
    return lib


def write_tensor_store(path, array):
    """Write a (N, ...) array as a fixed-record binary store + .meta sidecar."""
    array = np.ascontiguousarray(array)
    array.tofile(path)
    np.save(path + ".meta.npy",
            {"shape": array.shape, "dtype": str(array.dtype)},
            allow_pickle=True)
    return path


def read_store_meta(path):
    meta = np.load(path + ".meta.npy", allow_pickle=True).item()
    return tuple(meta["shape"]), np.dtype(meta["dtype"])


class NativeBatchSampler:
    """Infinite iterator over batches from one or more stores.

    :param store_paths: list of paths written by write_tensor_store; their
        record counts may differ (see csrc/batch_sampler.cpp for how each
        store's records are drawn).
    :param batch_size: records per batch.
    :param shuffle: random records; False takes consecutive windows.
    """

    def __init__(self, store_paths, batch_size, n_threads=2, capacity=4,
                 seed=0, shuffle=True):
        lib = _library()
        self._lib = lib
        self.batch_size = batch_size
        self._handle = lib.bs_create(batch_size, n_threads, capacity, seed,
                                     1 if shuffle else 0)
        if not self._handle:
            raise RuntimeError("bs_create failed")
        self._fields = []
        self.n_items = None
        try:
            for path in store_paths:
                shape, dtype = read_store_meta(path)
                if self.n_items is None:
                    self.n_items = shape[0]
                item_bytes = int(np.prod(shape[1:])) * dtype.itemsize
                rc = lib.bs_add_store(self._handle, path.encode(), item_bytes,
                                      shape[0])
                if rc != 0:
                    raise OSError(f"bs_add_store({path}) failed with {rc}")
                self._fields.append((shape[1:], dtype, item_bytes))
            rc = lib.bs_start(self._handle, n_threads)
            if rc != 0:
                raise RuntimeError(f"bs_start failed with {rc}")
        except BaseException:
            self.close()
            raise
        self._batch_bytes = lib.bs_batch_bytes(self._handle)

    def next(self):
        """:return: list of (batch_size, ...) arrays, one per store."""
        if self._handle is None:
            raise RuntimeError("the sampler is closed")
        with span("data.next"):
            buf = np.empty(self._batch_bytes, np.uint8)
            rc = self._lib.bs_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise RuntimeError(f"bs_next failed with {rc}")
        out = []
        offset = 0
        for shape, dtype, item_bytes in self._fields:
            nbytes = item_bytes * self.batch_size
            field = buf[offset:offset + nbytes].view(dtype)
            out.append(field.reshape((self.batch_size,) + tuple(shape)))
            offset += nbytes
        return out

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        if self._handle is not None:
            self._lib.bs_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()


class NativeTrainLoader:
    """Epoch-shaped dict-batch view over a NativeBatchSampler, in place of
    the Python DataLoader in the training loop (reference equivalent: torch
    DataLoader workers, train driver :43-56; here batch assembly is
    mmap+memcpy on C++ threads, no worker processes).

    :param store_dir: directory with poses.bin / textures.bin /
        backgrounds.bin written by data.pack_training_stores; an epoch is
        the poses store's record count over the batch size.
    """

    KEYS = ("pose", "texture", "background")

    def __init__(self, store_dir, batch_size, n_threads=2, seed=0):
        paths = [os.path.join(store_dir, f) for f in
                 ("poses.bin", "textures.bin", "backgrounds.bin")]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self._sampler = NativeBatchSampler(paths, batch_size,
                                           n_threads=n_threads, seed=seed)
        self.batch_size = batch_size
        self.steps_per_epoch = max(self._sampler.n_items // batch_size, 1)

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        for _ in range(self.steps_per_epoch):
            pose, texture, background = self._sampler.next()
            yield {"pose": pose, "texture": texture,
                   "background": background}

    def close(self):
        self._sampler.close()
