"""Production ingest: file/ring -> pinned host dispatch buffers -> async
H2D copies on a side stream -> the kernel main path.

Counterpart of ``singlecarrier_tpu/runtime/ingest.py``.  The reference's
ingest is a single-channel blocking fread loop (reference:
src/qpsk.c:436-458).  Feeding the batched RX at thousands of channels
needs a pipeline:

  mmap'd PCM (native/scio.cc)  ->  blocked deinterleave (native)
      ->  [B, C, frame_size] int16 dispatch buffer in pinned host memory
      ->  ``PrefetchIngest.put``: a ``non_blocking`` copy on a side CUDA
          stream, overlapped with the PREVIOUS dispatch's compute
      ->  ``prod_rx_batch``.

Two host-side assembly modes, both backed by the native engine:

  * "deinterleave" (default): one blocked ``scio_deinterleave`` per
    time-block turns the ADC-natural sample-major [frame, C] stream into
    the kernels' channel-major rows; with ``workers > 1`` a thread pool
    reads and transposes the blocks of a dispatch at once (ctypes
    releases the GIL);
  * "ring": samples flow through the lock-free SPSC ``FrameRing`` as a
    live capture thread would push them (one thread).

``PrefetchIngest`` assembles on a producer thread with a bounded queue,
so file IO and the transpose overlap the copy and the device's compute;
``feed()`` is the double-buffered drive loop.  Only the consumer thread
(the one iterating and calling ``put``) launches CUDA work.

A host buffer goes back to the producer only after its copy to the
device has finished: ``put`` records an event on the side stream against
the buffer, and the producer waits on that event before it overwrites
the buffer.  ``inflight`` (how many yielded buffers are held back before
recycling) keeps its meaning, but the copy's event is what makes the
recycling safe; on the CPU ``put`` returns the buffer itself, as the
JAX package's ``jnp.asarray`` aliases it, and ``inflight`` guards it.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from .engine import FrameRing, PcmFile, deinterleave


class PcmDispatchSource:
    """Interleaved int16 PCM file -> [B, C, frame_size] dispatch
    buffers.

    The file holds sample-major frames: sample s of channel c lives at
    ``(s*C + c)``.  ``loop=True`` wraps past EOF (steady-state
    throughput measurement from a bounded fixture file).
    """

    def __init__(self, path: str, channels: int, frame_size: int,
                 blocks_per_dispatch: int, *, loop: bool = False,
                 mode: str = "deinterleave", ring_capacity: int = 4,
                 workers: int = 1):
        if mode not in ("deinterleave", "ring"):
            raise ValueError(f"unknown ingest mode {mode!r}")
        self.file = PcmFile(path)
        self.C = channels
        self.n = frame_size
        self.B = blocks_per_dispatch
        self.loop = loop
        self.mode = mode
        self._off = 0
        self._total = self.file.n_samples
        self._block_samples = channels * frame_size
        if self._total < self._block_samples:
            raise ValueError(
                f"file holds {self._total} samples < one "
                f"[{channels} x {frame_size}] block")
        self._ring = (FrameRing(channels, frame_size,
                                capacity_blocks=ring_capacity)
                      if mode == "ring" else None)
        self._scratch = threading.local()   # one raw block per thread
        self._pool = (ThreadPoolExecutor(max_workers=workers)
                      if workers > 1 and mode == "deinterleave" else None)

    def _next_offset(self) -> int:
        """Sample offset of the next [frame_size * C] block (wrapping)."""
        if self._off + self._block_samples > self._total:
            if not self.loop:
                raise EOFError("stream exhausted")
            self._off = 0
        off = self._off
        self._off += self._block_samples
        return off

    def _read_raw(self, off: int) -> np.ndarray:
        """The interleaved block at ``off``, in this thread's scratch."""
        raw = getattr(self._scratch, "raw", None)
        if raw is None:
            raw = self._scratch.raw = np.empty(self._block_samples, np.int16)
        return self.file.read(off, self._block_samples, out=raw)

    def _deinterleave_block(self, off: int, out_b: np.ndarray) -> None:
        deinterleave(self._read_raw(off), self.C, out=out_b)

    def read_dispatch(self, out: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """Assemble one [B, C, frame_size] int16 dispatch buffer (into
        ``out``, e.g. a pinned tensor's ``.numpy()`` view)."""
        shape = (self.B, self.C, self.n)
        if out is None:
            out = np.empty(shape, np.int16)
        elif (out.shape != shape or out.dtype != np.int16
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous int16 {shape}, got "
                             f"{out.dtype} {out.shape}")
        offsets = [self._next_offset() for _ in range(self.B)]
        if self._pool is not None:
            list(self._pool.map(self._deinterleave_block, offsets, out))
        elif self.mode == "deinterleave":
            for off, out_b in zip(offsets, out):
                self._deinterleave_block(off, out_b)
        else:
            for off, out_b in zip(offsets, out):
                raw = self._read_raw(off)
                pushed = self._ring.push(raw.reshape(self.n, self.C))
                if pushed != self.n or self._ring.pop(out=out_b) is None:
                    raise RuntimeError(f"frame ring took {pushed} of "
                                       f"{self.n} samples of a block")
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
        if self._ring is not None:
            self._ring.close()
        self.file.close()


class PrefetchIngest:
    """Producer-thread wrapper: assembles dispatch buffers ahead of the
    consumer so host IO and the transpose overlap the copy and the
    compute.

    ``depth`` bounds the producer's lead; ``inflight`` is how many
    previously yielded buffers are held back before recycling.  The
    depth + inflight + 1 buffers are allocated here, before the producer
    starts, on the host: pinned when ``device`` (the card unless it says
    otherwise) is a CUDA device, and a failure to pin raises.  Steady
    state allocates no host memory.  Iterating yields the host buffers
    (int16 tensors [B, C, frame_size]); hand each to :meth:`put`.
    """

    def __init__(self, source: PcmDispatchSource, n_dispatches: int,
                 *, depth: int = 2, inflight: int = 2, device=None):
        self.source = source
        self.n = n_dispatches
        self.inflight = inflight
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._ready: queue.Queue = queue.Queue(maxsize=depth)
        self._free: queue.Queue = queue.Queue()
        for _ in range(depth + inflight + 1):
            buf = torch.empty((source.B, source.C, source.n),
                              dtype=torch.int16, pin_memory=cuda)
            if cuda and not buf.is_pinned():
                raise RuntimeError("a dispatch buffer could not be pinned")
            self._free.put((buf, None))
        # the side stream of the copies, and each host buffer's latest
        # copy (its data pointer -> the event recorded after the copy)
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._copies: dict = {}
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for _ in range(self.n):
                buf, copied = self._free.get()
                if copied is not None:
                    copied.synchronize()     # its copy to the device is done
                self.source.read_dispatch(out=buf.numpy())
                self._ready.put(buf)
        except BaseException as e:   # surfaced on the consumer side
            self._err = e
            self._ready.put(None)

    def put(self, host: torch.Tensor) -> torch.Tensor:
        """The buffer ``host`` on the device, for ``feed``.

        On a CUDA device: a ``non_blocking`` copy on the side stream into
        memory allocated there, an event after it that the current
        (consuming) stream waits on, ``record_stream`` so the caching
        allocator keeps the memory until the consuming stream is done
        with it, and the event recorded against ``host`` so the buffer
        is not refilled before the copy has read it.  On the CPU: the
        buffer itself.
        """
        if self._copy_stream is None:
            return host
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        consumer.wait_event(copied)
        dev.record_stream(consumer)
        self._copies[host.data_ptr()] = copied
        return dev

    def __iter__(self) -> Iterator[torch.Tensor]:
        held: deque = deque()
        for _ in range(self.n):
            buf = self._ready.get()
            if buf is None:
                raise RuntimeError("ingest producer failed") \
                    from self._err
            yield buf
            held.append(buf)
            if len(held) > self.inflight:
                old = held.popleft()
                self._free.put((old, self._copies.pop(old.data_ptr(), None)))


def feed(ingest: PrefetchIngest, put: Callable, step: Callable,
         state):
    """Double-buffered drive loop: the copy of dispatch k+1 overlaps the
    device compute of dispatch k.

    ``put(host_buf) -> device tensor`` is ``ingest.put``;
    ``step(state, dev) -> (state, chk)`` launches the dispatch's work
    without waiting for it (``prod_rx_batch`` on the card does).
    Returns (state, last chk) -- the caller syncs once after the loop.
    """
    it = iter(ingest)
    try:
        nxt = put(next(it))
    except StopIteration:
        return state, None
    chk = None
    while True:
        dev, nxt = nxt, None
        state, chk = step(state, dev)    # async on the device
        try:
            host_next = next(it)         # overlaps device compute
        except StopIteration:
            break
        nxt = put(host_next)             # H2D while the device computes
    return state, chk
