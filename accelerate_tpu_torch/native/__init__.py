"""The native token loader (port of `accelerate_tpu/native/__init__.py`).

`_native/token_loader.cpp` memory-maps a flat token file and assembles
shuffled, process-sharded batches on producer threads behind a C ABI.
It is host C++, built with `g++` at first use into `BUILD_DIR`
(`accelerate_tpu_torch/_native/_build/`), cached under a hash of the
source and the flags, and loaded with ctypes. ctypes releases the
interpreter lock while `atl_loader_next` waits, so the producer threads
never hold the training step's thread back.

`TokenCorpusLoader` iterates the native batches, or with
`force_fallback=True` (or when the library did not build) a numpy
version of the same semantics: the same permutation (SplitMix64
Fisher-Yates), the same shard and the same wraparound, so the two give
equal batches. Its threads and the loader's never touch CUDA.

The reference reads two environment variables that the port takes as
module constants instead: `BUILD_DIR` (the reference's
`ACCELERATE_TPU_NATIVE_CACHE`) and `EXACT_SHUFFLE_MAX` (the reference's
`ACCELERATE_TPU_EXACT_SHUFFLE_MAX`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "_native" / \
    "token_loader.cpp"
# where the library builds; set before the first use to build elsewhere
BUILD_DIR = _SRC.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the largest corpus (in samples) whose fallback shuffle reproduces the
# native one bit for bit (its swap loop is sequential Python, ~1 s per 2M)
EXACT_SHUFFLE_MAX = 2_000_000

_DTYPES = {np.dtype(np.uint16): 0, np.dtype(np.int32): 1,
           np.dtype(np.uint32): 2}

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None
# {"seconds": g++'s wall time (0.0 when the cache hit), "path": the .so}
build_info: dict = {}


def _lib_path() -> Path:
    """The library's path in the cache, keyed on the source and flags."""
    h = hashlib.sha256(_SRC.read_bytes() + b"\0" + " ".join(CXX_FLAGS)
                       .encode())
    return Path(BUILD_DIR) / f"libatl-{h.hexdigest()[:16]}.so"


def _safe_dir(path: Path) -> None:
    """Create the build directory; refuse one this user does not own or
    that others can write, since a library planted there would be loaded
    into the training process."""
    path.mkdir(mode=0o700, parents=True, exist_ok=True)
    st = path.stat()
    if st.st_uid != os.getuid() or st.st_mode & 0o022:
        raise OSError(f"native build directory {path} is not private to "
                      "this user")


def _load_library():
    """Compile (once) and load the native library; None if it cannot."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            so_path = _lib_path()
            t0 = time.perf_counter()
            if not so_path.exists():
                _safe_dir(so_path.parent)
                # a unique temporary output and an atomic rename: processes
                # racing this build never load a half-written library
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so_path)
                build_info["seconds"] = time.perf_counter() - t0
            else:
                build_info["seconds"] = 0.0
            build_info["path"] = str(so_path)
            lib = ctypes.CDLL(str(so_path))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = getattr(e, "stderr", None) or str(e)
            return None
        lib.atl_open.restype = ctypes.c_void_p
        lib.atl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
        lib.atl_num_samples.restype = ctypes.c_long
        lib.atl_num_samples.argtypes = [ctypes.c_void_p]
        lib.atl_num_tokens.restype = ctypes.c_long
        lib.atl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.atl_close.argtypes = [ctypes.c_void_p]
        lib.atl_loader_new.restype = ctypes.c_void_p
        lib.atl_loader_new.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.atl_loader_batches_per_epoch.restype = ctypes.c_long
        lib.atl_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.atl_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.atl_loader_next.restype = ctypes.c_int
        lib.atl_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
        ]
        lib.atl_loader_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    """True if the native library is built (or buildable) here."""
    return _load_library() is not None


def build_error() -> str | None:
    """Why the library did not build (the compiler's output), or None."""
    _load_library()
    return _build_error


_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64_draws(seed: int, epoch: int, n: int) -> np.ndarray:
    """The SplitMix64 stream token_loader.cpp uses, vectorised: draw k is
    mix(seed_epoch + (k+1) * GAMMA)."""
    gamma = np.uint64(0x9E3779B97F4A7C15)
    s0 = np.uint64((seed ^ (epoch * 0xD1B54A32D192ED03)) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        z = (s0 + (np.arange(1, n + 1, dtype=np.uint64)) * gamma) & _MASK64
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
            & _MASK64
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
            & _MASK64
        return z ^ (z >> np.uint64(31))


def _epoch_order(num_samples: int, seed: int, epoch: int, shuffle: bool,
                 rank: int, world: int) -> np.ndarray:
    """The permutation and shard the C++ side computes (SplitMix64
    Fisher-Yates, wraparound stride shard), so native and fallback
    processes see the same epoch orders and disjoint shards."""
    idx = np.arange(num_samples, dtype=np.int64)
    if shuffle and num_samples > 1:
        if num_samples > EXACT_SHUFFLE_MAX:
            # the bit-exact swap loop is sequential Python; above this size
            # numpy's shuffle runs instead: still deterministic per (seed,
            # epoch), but not the native order
            warnings.warn(
                f"corpus has {num_samples} samples; fallback shuffle switches "
                "to numpy (not bit-identical to the native loader). Ensure "
                "all processes use the same implementation, or raise "
                "accelerate_tpu_torch.native.EXACT_SHUFFLE_MAX.",
                stacklevel=2,
            )
            rng = np.random.default_rng(
                (seed ^ (epoch * 0xD1B54A32D192ED03)) & 0xFFFFFFFF)
            rng.shuffle(idx)
        else:
            draws = _splitmix64_draws(seed, epoch, num_samples - 1)
            for k, i in enumerate(range(num_samples - 1, 0, -1)):
                j = int(draws[k] % np.uint64(i + 1))
                idx[i], idx[j] = idx[j], idx[i]
    per = -(-num_samples // world)
    take = (rank + np.arange(per, dtype=np.int64) * world) % num_samples
    return idx[take]


class TokenCorpusLoader:
    """Iterate `{"input_ids": int32 [batch, sample_len]}` batches (numpy)
    from a flat binary token file.

    A sized batch iterable: it goes straight into `Accelerator.prepare` or
    `prepare_data_loader`. With `rank`/`world` it shards the corpus itself
    and sets `is_host_sharded`, so `prepare_data_loader` does not stride
    its batches across processes a second time.

    The native library runs it unless `force_fallback=True`.
    """

    def __init__(
        self,
        path: str,
        sample_len: int,
        batch_size: int,
        dtype: np.dtype | str = np.int32,
        shuffle: bool = True,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        drop_last: bool = True,
        threads: int = 2,
        prefetch_depth: int = 4,
        force_fallback: bool = False,
    ) -> None:
        self.path = path
        self.sample_len = int(sample_len)
        self.batch_size = int(batch_size)
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype {self.dtype} not supported; use uint16/int32/uint32")
        self.shuffle = shuffle
        self.seed = int(seed)
        self.rank, self.world = int(rank), int(world)
        if self.world <= 0 or not (0 <= self.rank < self.world):
            raise ValueError(f"invalid shard rank={rank} world={world}")
        if self.batch_size <= 0 or self.sample_len <= 0:
            raise ValueError(
                f"batch_size/sample_len must be positive, got "
                f"{batch_size}/{sample_len}"
            )
        # prepare_data_loader must not shard again: this loader already
        # yields only this process's shard
        self.is_host_sharded = self.world > 1
        self.drop_last = drop_last
        self.threads, self.prefetch_depth = threads, prefetch_depth
        self.epoch = 0

        self._lib = None if force_fallback else _load_library()
        self._corpus = None
        self._loader = None
        if self._lib is not None:
            self._corpus = self._lib.atl_open(
                path.encode(), _DTYPES[self.dtype], self.sample_len
            )
            if not self._corpus:
                raise FileNotFoundError(f"cannot mmap token file {path}")
            self.num_samples = self._lib.atl_num_samples(self._corpus)
            self._loader = self._lib.atl_loader_new(
                self._corpus, self.batch_size, int(shuffle), self.seed,
                self.rank, self.world, int(drop_last), threads,
                prefetch_depth,
            )
            if not self._loader:
                raise RuntimeError(
                    "native loader creation failed (args rejected by "
                    "atl_loader_new)"
                )
        else:
            self._mm = np.memmap(path, dtype=self.dtype, mode="r")
            self.num_samples = len(self._mm) // self.sample_len
        per = -(-self.num_samples // self.world)
        self.num_batches = (
            per // self.batch_size if drop_last
            else -(-per // self.batch_size)
        )
        # drop_last=False wraps the final batch with recycled rows: report
        # them like every other loader, so gather_for_metrics can drop them
        # (DataLoaderShard reads these at the end of a pass). Exact only
        # when the shards are even (num_samples % world == 0); otherwise
        # the wrapped rows are duplicates across processes that the
        # uniform (processes, batch, real) layout cannot name
        real_tail = per - self.batch_size * (self.num_batches - 1)
        if (not drop_last and 0 < real_tail < self.batch_size
                and self.num_samples % self.world == 0):
            self.remainder = real_tail * self.world
            self.tail_layout = (self.world, self.batch_size, real_tail)
        else:
            self.remainder = -1
            self.tail_layout = None

    @property
    def native(self) -> bool:
        """True when the native library produces the batches."""
        return self._loader is not None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        if self._loader is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_fallback()
        self.epoch += 1

    def _iter_native(self):
        out = np.empty((self.batch_size, self.sample_len), np.int32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._lib.atl_loader_start_epoch(self._loader, self.epoch)
        while True:
            rc = self._lib.atl_loader_next(self._loader, ptr)
            if rc != 0:
                break
            yield {"input_ids": out.copy()}

    def _iter_fallback(self):
        order = _epoch_order(
            self.num_samples, self.seed, self.epoch, self.shuffle,
            self.rank, self.world,
        )
        L, B = self.sample_len, self.batch_size
        tokens = self._mm
        n = len(order)
        for b in range(self.num_batches):
            rows = [order[(b * B + i) % n] for i in range(B)]
            batch = np.stack(
                [np.asarray(tokens[r * L : (r + 1) * L], dtype=np.int32)
                 for r in rows]
            )
            yield {"input_ids": batch}

    def close(self) -> None:
        """Stop the producer threads and unmap the corpus."""
        if self._loader is not None:
            self._lib.atl_loader_free(self._loader)
            self._loader = None
        if self._corpus is not None:
            self._lib.atl_close(self._corpus)
            self._corpus = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def write_token_file(path: str, tokens: np.ndarray) -> str:
    """Write a flat binary token file in a supported dtype (others are
    written as int32)."""
    arr = np.ascontiguousarray(tokens)
    if arr.dtype not in _DTYPES:
        arr = arr.astype(np.int32)
    arr.tofile(path)
    return path
