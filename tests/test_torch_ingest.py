"""PyTorch port: the native PCM engine and the ingest pipeline
(``singlecarrier_tpu_torch.runtime.engine`` / ``.ingest``) on the CPU.

The engine is the port's own build of ``native/scio.cc`` (under
``build/torch_native/``): its transposes are held to numpy's, the ring
and the mmap'd file to ``tests/test_native_engine.py``'s cases and to
the C harness's ``tx_pcm``.  The pipeline (file -> producer thread ->
``feed`` -> ``prod_rx_batch(fuse_frontend=True)``, its plain version
here) must give the outputs of ``prod_rx_batch`` called directly on the
same frames, to the bit, in both assembly modes with 1 and 4 workers.
A stand-in ``g++`` on ``PATH`` shows two processes building the library
once.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from singlecarrier_tpu.config import DEFAULT_CONFIG as JCFG  # noqa: E402
from singlecarrier_tpu_torch import interop  # noqa: E402
from singlecarrier_tpu_torch.modem import (prod_rx_batch,  # noqa: E402
                                           prod_rx_init_planes, tx_stream)
from singlecarrier_tpu_torch.runtime import engine  # noqa: E402
from singlecarrier_tpu_torch.runtime.ingest import (  # noqa: E402
    PcmDispatchSource, PrefetchIngest, feed)

ROOT = Path(__file__).resolve().parents[1]
CFG = interop.config_from_dict(dataclasses.asdict(JCFG)).replace(
    decim_dtype="bf16", hunt_dtype="int8", ls_refit_symbols=128)


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("shape", [(16, 1000), (3, 1880), (130, 77)])
def test_transposes_equal_numpy(shape):
    rng = np.random.default_rng(0)
    chans = rng.integers(-32768, 32768, shape, dtype=np.int16)
    inter = engine.interleave(chans)
    assert np.array_equal(inter, chans.T.reshape(-1))   # sample-major
    assert np.array_equal(engine.deinterleave(inter, shape[0]), chans)
    out = np.empty(shape, np.int16)
    assert engine.deinterleave(inter, shape[0], out=out) is out
    assert np.array_equal(out, chans)
    with pytest.raises(ValueError):
        engine.deinterleave(inter, shape[0], out=np.empty(3, np.int16))


def test_frame_ring():
    rng = np.random.default_rng(1)
    n_ch, fs = 4, 100
    ring = engine.FrameRing(n_ch, fs, capacity_blocks=4)
    chans = rng.integers(-100, 100, (n_ch, 250), dtype=np.int16)
    inter = engine.interleave(chans).reshape(250, n_ch)

    # push in odd-sized chunks
    assert ring.push(inter[:77]) == 77
    assert ring.blocks_ready == 0
    assert ring.push(inter[77:160]) == 83
    assert ring.blocks_ready == 1
    assert ring.push(inter[160:]) == 90
    assert ring.blocks_ready == 2

    b0 = ring.pop()
    b1 = np.empty((n_ch, fs), np.int16)
    assert ring.pop(out=b1) is b1
    assert ring.pop() is None
    assert np.array_equal(b0, chans[:, :100])
    assert np.array_equal(b1, chans[:, 100:200])
    ring.close()


def test_ring_backpressure():
    ring = engine.FrameRing(2, 10, capacity_blocks=2)
    data = np.zeros((100, 2), np.int16)
    consumed = ring.push(data)
    # the ring refuses once full: 2 blocks * 10 samples
    assert consumed == 20
    assert ring.blocks_ready == 2
    ring.pop()
    assert ring.push(data[consumed:]) == 10
    ring.close()


def test_pcm_file(tmp_path):
    p = str(tmp_path / "x.raw")
    data = np.arange(-500, 500, dtype=np.int16)
    data.tofile(p)
    f = engine.PcmFile(p)
    assert f.n_samples == 1000
    assert np.array_equal(f.read(0, 10), data[:10])
    assert np.array_equal(f.read(990, 20)[:10], data[990:])
    assert np.all(f.read(990, 20)[10:] == 0)  # zero-padded past EOF
    f.close()
    with pytest.raises(FileNotFoundError):
        engine.PcmFile(str(tmp_path / "missing.raw"))


def test_pcm_file_on_the_c_harness_stream(golden, tmp_path):
    """The C harness's ``tx_pcm`` (the reference's golden vector) through
    the mmap'd reader: 27,830 samples, zero padding past EOF."""
    tx = golden["tx_pcm"].astype(np.int16)
    p = str(tmp_path / "tx_pcm.raw")
    tx.tofile(p)
    f = engine.PcmFile(p)
    assert f.n_samples == 27830
    assert np.array_equal(f.read(0, 27830), tx)
    tail = f.read(27830 - 1880 + 100, 1880)
    assert np.array_equal(tail[:1780], tx[-1780:])
    assert np.all(tail[1780:] == 0)
    f.close()


def test_library_is_the_ports_own_build():
    lib = engine.load_library()
    assert Path(lib._name) == ROOT / "build" / "torch_native" / "libscio.so"
    assert engine.BUILD_DIR == ROOT / "build" / "torch_native"
    assert engine.SOURCE == ROOT / "native" / "scio.cc"


def test_compiler_flags_are_the_makefiles():
    text = (ROOT / "native" / "Makefile").read_text()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("=", 1)[1].split()) == engine.CXXFLAGS


FAKE_GXX = """#!{python}
import pathlib, sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
time.sleep(0.5)
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"fake library")
"""

BUILD_SCRIPT = """
import pathlib, sys, time
from singlecarrier_tpu_torch.runtime import engine
build_dir, ready, go = map(pathlib.Path, sys.argv[1:4])
ready.touch()
while not go.exists():
    time.sleep(0.01)
print(engine.build(build_dir))
"""


def test_two_processes_build_the_library_once(tmp_path):
    """Two processes that build at once: one compiler run, one library,
    no temporary file left."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "gxx.log"
    gxx = bindir / "g++"
    gxx.write_text(FAKE_GXX.format(python=sys.executable, log=str(log)))
    gxx.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    env["PATH"] = f"{bindir}{os.pathsep}{env['PATH']}"
    build_dir, go = tmp_path / "build", tmp_path / "go"
    ready = [tmp_path / f"ready{i}" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(r),
         str(go)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in ready]
    try:
        deadline = time.monotonic() + 120
        while not all(r.exists() for r in ready):
            assert time.monotonic() < deadline, "no process started"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        go.touch()
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], results
    paths = {out.strip() for out, _ in results}
    assert paths == {str(build_dir / "libscio.so")}
    assert len(log.read_text().splitlines()) == 1
    assert (build_dir / "libscio.so").read_bytes() == b"fake library"
    assert sorted(p.name for p in build_dir.iterdir()) == [
        "libscio.lock", "libscio.so"]


# ------------------------------------------------------------- the ingest

C, B, N_DISP = 2, 4, 2


@pytest.fixture(scope="module")
def ingest_file(tmp_path_factory):
    """Three packets of the port's TX on every one of C channels,
    interleaved into a file of N_DISP dispatches; the sent bits and the
    frames [N_DISP * B, C, frame_size]."""
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, bits, flush_gap=True, device="cpu").numpy()
    stream = np.zeros(N_DISP * B * CFG.frame_size, np.int16)
    stream[:len(pcm)] = pcm
    path = str(tmp_path_factory.mktemp("ingest") / "ingest.raw")
    np.repeat(stream, C).astype(np.int16).tofile(path)
    frames = np.broadcast_to(stream.reshape(-1, 1, CFG.frame_size),
                             (N_DISP * B, C, CFG.frame_size)).copy()
    return path, bits, frames


def _step(outs):
    def step(state, dev):
        state, out = prod_rx_batch(CFG, state, dev, descramble=False,
                                   fuse_frontend=True)
        outs.append(out)
        return state, out.valid.sum()
    return step


def _direct(frames, blocks_per_dispatch):
    state = prod_rx_init_planes(CFG, C, "cpu")
    outs = []
    step = _step(outs)
    for k in range(0, len(frames), blocks_per_dispatch):
        state, _ = step(state, torch.from_numpy(
            frames[k:k + blocks_per_dispatch]))
    return state, outs


def _assert_same(outs, ref):
    assert len(outs) == len(ref)
    for out, want in zip(outs, ref):
        for x, y in zip(out, want):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("mode,workers,depth,inflight", [
    ("deinterleave", 1, 2, 2), ("deinterleave", 4, 2, 2),
    ("ring", 1, 2, 2), ("ring", 4, 2, 2), ("deinterleave", 4, 1, 0)])
def test_ingest_pipeline_equals_the_direct_main_path(ingest_file, mode,
                                                     workers, depth,
                                                     inflight):
    path, bits, frames = ingest_file
    src = PcmDispatchSource(path, C, CFG.frame_size, B, mode=mode,
                            workers=workers)
    ingest = PrefetchIngest(src, N_DISP, depth=depth, inflight=inflight,
                            device="cpu")
    outs = []
    state, chk = feed(ingest, ingest.put, _step(outs),
                      prod_rx_init_planes(CFG, C, "cpu"))
    src.close()
    ref_state, ref = _direct(frames, B)
    _assert_same(outs, ref)
    for x, y in zip(state, ref_state):
        assert torch.equal(x, y)
    valid = torch.cat([o.valid for o in outs]).numpy()
    got = torch.cat([o.bits for o in outs]).numpy()
    assert valid.sum() == 3 * C and int(chk) == int(outs[-1].valid.sum())
    for c in range(C):
        assert np.array_equal(got[:, c][valid[:, c]],
                              bits.reshape(3, CFG.bits_per_frame))


def test_producer_error_surfaces(ingest_file):
    path, _, _ = ingest_file
    src = PcmDispatchSource(path, C, CFG.frame_size, B)
    ingest = PrefetchIngest(src, N_DISP + 1, device="cpu")   # past EOF
    with pytest.raises(RuntimeError, match="producer failed") as err:
        list(ingest)
    assert isinstance(err.value.__cause__, EOFError)
    src.close()


def test_buffers_are_host_tensors_and_put_is_the_buffer_on_the_cpu(
        ingest_file):
    path, _, frames = ingest_file
    src = PcmDispatchSource(path, C, CFG.frame_size, B)
    ingest = PrefetchIngest(src, N_DISP, depth=1, inflight=0, device="cpu")
    for k, buf in enumerate(ingest):
        assert buf.dtype == torch.int16 and not buf.is_pinned()
        assert ingest.put(buf) is buf
        assert np.array_equal(buf.numpy(), frames[k * B:(k + 1) * B])
    src.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PrefetchIngest(PcmDispatchSource(path, C, CFG.frame_size, B), 1)


class _Copy:
    """A stand-in for the event ``put`` records against a buffer on the
    card: it notes the buffer's contents, and on ``synchronize`` (the
    producer waiting before a refill) checks that they are untouched."""

    def __init__(self, buf, log):
        self.buf, self.log = buf, log
        self.snapshot = buf.clone()

    def synchronize(self):
        self.log.append(torch.equal(self.buf, self.snapshot))


def test_producer_waits_on_the_copy_before_refilling(ingest_file):
    """With one spare buffer (depth 1, inflight 0) and a looped file of
    distinct dispatches, every refill first waits on the event recorded
    against that buffer, and the buffer still holds what was copied."""
    path, _, frames = ingest_file
    src = PcmDispatchSource(path, C, CFG.frame_size, 1, loop=True)
    n = 6
    ingest = PrefetchIngest(src, n, depth=1, inflight=0, device="cpu")
    log = []
    for k, buf in enumerate(ingest):
        assert np.array_equal(buf.numpy()[0], frames[k % len(frames)])
        ingest._copies[buf.data_ptr()] = _Copy(buf, log)
        time.sleep(0.01)
    src.close()
    # two buffers: every dispatch after the first two refills one
    assert log == [True] * (n - 2)


def test_parallel_assembly_under_contention(ingest_file):
    """Many workers and a short switch interval: the dispatches come out
    whole and in order."""
    path, _, frames = ingest_file
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        src = PcmDispatchSource(path, C, CFG.frame_size, B, loop=True,
                                workers=32)
        for k in range(2 * N_DISP):
            out = src.read_dispatch()
            j = (k % N_DISP) * B
            assert np.array_equal(out, frames[j:j + B])
        src.close()
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() < 100
