"""ctypes bridge to the port's native C++ data loader
(``tcnn_tpu_torch/native/tcnn_loader.cpp``; ``tcnn_tpu/utils/native_loader.py``).

Host-side training-data pipeline: a C++ thread pool samples random
(uv, rgb) batches from an image while the card trains, and a Python
prefetch thread keeps batches ahead of the training loop, already on the
card: the host-data counterpart of the reference's on-GPU data
generation (mlp_learning_an_image.cu:229-243), for data that lives on
the host.

The shared library builds on first use with g++ (plain extern "C" ABI)
into ``build/native/`` at the root of the checkout, a directory
``.gitignore`` lists, under a name that carries a hash of the source, the
flags and the CPU: a build writes a temporary file in that directory and
renames it into place, so processes that build at once (test workers)
each load a whole library, and a changed source, or another CPU, builds
anew.  The flags are the JAX package's, so both libraries draw the same
samples bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import queue
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..common import resolve_device

_SRC = Path(__file__).resolve().parents[1] / "native" / "tcnn_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
ABI_VERSION = 1
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags
    (Linux), else the machine type."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    return "\n".join(sorted({ln for ln in lines
                              if ln.startswith(("model name", "flags"))})).encode()


def library_path() -> Path:
    """The library's path: its name carries a hash of the source, the
    flags and the host's CPU, so that a checkout copied to another machine
    builds its own."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _host_cpu()).hexdigest()
    return BUILD_DIR / f"libtcnn_loader-{digest[:16]}.so"


def build(path: Optional[Path] = None) -> Path:
    """Compile the loader to ``path`` (``library_path()`` where None): to a
    temporary file in the same directory, then renamed into place, so that
    no process ever loads a half-written library."""
    path = Path(path or library_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """Build (where its library is missing) and load the native loader."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        lib.tcnn_sampler_create.restype = ctypes.c_void_p
        lib.tcnn_sampler_create.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.tcnn_sampler_destroy.argtypes = [ctypes.c_void_p]
        lib.tcnn_sampler_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.tcnn_sampler_grid.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.tcnn_loader_abi_version.restype = ctypes.c_int
        if lib.tcnn_loader_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{path}: loader ABI {lib.tcnn_loader_abi_version()}, "
                               f"expected {ABI_VERSION}")
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return False


def _fptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_float))


class NativeImageSampler:
    """Threaded host-side image sampler, deterministic per seed whatever
    the thread count.  Samples are float32 CPU tensors: uv in [0, 1)² and
    the bilinear texel fetch at uv (the texel-centre convention of
    ``utils.image.ImageSampler.sample_at``)."""

    def __init__(self, image, n_threads: int = 0):
        self._lib = load_library()
        img = np.ascontiguousarray(
            image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else image,
            np.float32)
        self.height, self.width, self.channels = img.shape
        self._handle = self._lib.tcnn_sampler_create(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.height, self.width,
            self.channels, n_threads)
        if not self._handle:
            raise RuntimeError("native sampler creation failed")

    def sample(self, n: int, seed: int, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(xy (n, 2), values (n, C)); written into ``out`` (two contiguous
        float32 CPU tensors of those shapes, pinned ones for a copy to the
        card) where given."""
        if out is None:
            out = (torch.empty((n, 2)), torch.empty((n, self.channels)))
        xy, val = out
        if (xy.shape != (n, 2) or val.shape != (n, self.channels) or xy.device.type != "cpu"
                or any(t.dtype != torch.float32 or not t.is_contiguous() for t in out)):
            raise ValueError(f"sample: out must be contiguous float32 CPU tensors (n, 2) and "
                             f"(n, {self.channels})")
        self._lib.tcnn_sampler_sample(self._handle, n, ctypes.c_uint64(seed), _fptr(xy),
                                      _fptr(val))
        return xy, val

    def full_grid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.height * self.width
        xy, val = torch.empty((n, 2)), torch.empty((n, self.channels))
        self._lib.tcnn_sampler_grid(self._handle, _fptr(xy), _fptr(val))
        return xy, val

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tcnn_sampler_destroy(handle)
            self._handle = None


class PrefetchingSampler:
    """Keeps ``depth`` sampled batches ready on ``device`` (the card where
    None), so the training loop waits neither on host-side sampling nor on
    the copy.  Batch i is drawn with seed ``seed · 1000003 + i``, as in the
    JAX package.

    On the card a worker thread samples into a ring of pinned host buffers
    and copies each batch to the device with ``non_blocking=True`` on a side
    stream, recording an event after the copy; ``next()`` makes the
    caller's current stream wait on that event (no host synchronisation)
    and marks the batch as used on that stream, so that the allocator keeps
    its memory until the stream is done with it.  The worker waits for a
    buffer's copy to finish before it samples into that buffer again.  On
    the CPU (``device="cpu"``) the batches are the sampled tensors."""

    def __init__(self, sampler: NativeImageSampler, batch_size: int, seed: int = 0,
                 depth: int = 2, device=None):
        self.sampler = sampler
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._seed = seed
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        n_buffers = depth + 2 if cuda else 0   # depth queued, one being consumed, one filling
        self._buffers = [(torch.empty((batch_size, 2)).pin_memory(),
                          torch.empty((batch_size, sampler.channels)).pin_memory(), None)
                         for _ in range(n_buffers)]
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        i = 0
        while not self._stop.is_set():
            seed = self._seed * 1_000_003 + i
            if self._stream is None:
                item = self.sampler.sample(self.batch_size, seed)
            else:
                k = i % len(self._buffers)
                xy_h, val_h, done = self._buffers[k]
                if done is not None:
                    done.synchronize()   # the previous copy out of this buffer
                self.sampler.sample(self.batch_size, seed, out=(xy_h, val_h))
                with torch.cuda.stream(self._stream):
                    xy = xy_h.to(self.device, non_blocking=True)
                    val = val_h.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                self._buffers[k] = (xy_h, val_h, ready)
                item = (xy, val, ready)
            if not self._put(item):
                return
            i += 1

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        item = self._queue.get()
        if self._stream is None:
            return item
        xy, val, ready = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        xy.record_stream(stream)
        val.record_stream(stream)
        return xy, val

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
