"""PyTorch port: the runtime layer (``singlecarrier_tpu_torch.runtime``)
on the CPU -- StreamDemodulator against the JAX package's, checkpoint and
resume, metrics and profiling.

The stream is ``tests/test_runtime.py``'s: four packets of the JAX TX
(seed 21), flushed gap, on 3 channels.  The port's ``StreamDemodulator``
is held to the JAX one block by block by the North star's criterion
(identical valid, bits on valid blocks, lag and phase on detected
blocks, |dcfo| < 0.5 Hz, |deq_error| < 2e-3) and to the TX bits;
checkpoint and resume must equal the unbroken run to the bit.  The JAX
side runs only its XLA path.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx_stream as jtx_stream
from singlecarrier_tpu.runtime import StreamDemodulator as JStreamDemodulator
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (GatedRxState, ProdRxOut,
                                           RxState, prod_rx_batch,
                                           prod_rx_gated_init, prod_rx_init,
                                           prod_rx_init_planes, rx_init)
from singlecarrier_tpu_torch.ops import _build
from singlecarrier_tpu_torch.runtime import (MetricsAggregator,
                                             StreamDemodulator,
                                             ThroughputMeter, log_compiles,
                                             restore_state, save_state, trace)

TCFG = interop.config_from_dict(dataclasses.asdict(CFG))
# bench.py's operating point, the main path's
BENCH = TCFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                     ls_refit_symbols=128)


def _stream(n_channels=3, n_packets=4, seed=21):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_packets, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(jtx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n_blocks = -(-len(pcm) // CFG.frame_size)
    buf = np.zeros(n_blocks * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    blocks = buf.reshape(n_blocks, CFG.frame_size)
    return bits, np.broadcast_to(blocks[:, None, :],
                                 (n_blocks, n_channels,
                                  CFG.frame_size)).copy()


@pytest.fixture(scope="module")
def stream21():
    return _stream()


def _agree(t, j) -> None:
    """The North star's criterion: port output ``t`` (tensors) against
    the JAX one ``j`` on one block."""
    v = np.asarray(j.valid)
    assert np.array_equal(t.valid.numpy(), v)
    for name in ("bits", "lag", "timing_phase"):
        assert np.array_equal(getattr(t, name).numpy()[v],
                              np.asarray(getattr(j, name))[v]), name
    assert np.array_equal(t.matches.numpy(), np.asarray(j.matches))
    if v.any():
        assert np.abs(t.cfo_hz.numpy()[v]
                      - np.asarray(j.cfo_hz)[v]).max() < 0.5
        assert np.abs(t.eq_error.numpy()[v]
                      - np.asarray(j.eq_error)[v]).max() < 2e-3


def _assert_equal(a, b) -> None:
    """Every field of two outputs (or states) equal to the bit."""
    assert type(a) is type(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_stream_demodulator_matches_jax(stream21):
    bits, blocks = stream21
    jd = JStreamDemodulator(CFG, n_channels=3, descramble=False)
    td = StreamDemodulator(TCFG, n_channels=3, descramble=False,
                           device="cpu")
    packets = []
    for block in list(blocks) + [None]:
        if block is None:                       # drain the hunt latency
            jo, to = jd.flush(), td.flush()
        else:
            jo, to = jd.push(block), td.push(block)
        _agree(to, jo)
        packets += td.collect_packets(to)
    assert td.blocks_processed == len(blocks) + 1
    # 4 packets x 3 channels, each equal to the TX bits
    assert len(packets) == 12
    ref = bits.reshape(4, CFG.bits_per_frame)
    for c in range(3):
        got = np.stack([b for ch, b in packets if ch == c])
        assert np.array_equal(got, ref)
    ts, js = td.metrics.summary(), jd.metrics.summary()
    assert ts["blocks"] == js["blocks"] == len(blocks) + 1
    assert ts["packets"] == js["packets"] == 12
    assert ts["mean_matches"] == js["mean_matches"] == 128.0
    assert abs(ts["mean_cfo_hz"] - js["mean_cfo_hz"]) < 0.5
    assert abs(ts["mean_eq_error"] - js["mean_eq_error"]) < 2e-3


def test_checkpoint_resume_bit_identical(tmp_path):
    """Stop mid-stream, checkpoint the ProdRxState, restore it in a fresh
    demodulator, continue: every output field equal to the unbroken
    run's."""
    _, blocks = _stream(seed=22)
    cut = len(blocks) // 2

    full = StreamDemodulator(TCFG, 3, descramble=False, device="cpu")
    full_out = [full.push(b) for b in blocks]

    a = StreamDemodulator(TCFG, 3, descramble=False, device="cpu")
    for b in blocks[:cut]:
        a.push(b)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_state(path, a.state, step=cut)

    b2 = StreamDemodulator(TCFG, 3, descramble=False, device="cpu")
    b2.state, step = restore_state(path, like=b2.state)
    assert step == cut
    for i, blk in enumerate(blocks[cut:]):
        _assert_equal(b2.push(blk), full_out[cut + i])
    _assert_equal(b2.state, full.state)


def test_checkpoint_resume_plane_state_main_path(stream21, tmp_path):
    """The bf16 plane tuple through ``prod_rx_batch(fuse_frontend=True)``
    (its plain version) at the bench operating point: two dispatches
    unbroken, and the same with the state saved and restored between
    them, equal to the bit."""
    _, blocks = stream21
    half = len(blocks) // 2
    frames = torch.from_numpy(blocks[:2 * half])
    parts = (frames[:half], frames[half:])

    def run(state, part):
        return prod_rx_batch(BENCH, state, part, descramble=False,
                             fuse_frontend=True)

    st, out0 = run(prod_rx_init_planes(BENCH, 3, "cpu"), parts[0])
    full_state, full_out = run(st, parts[1])
    assert int(out0.valid.sum() + full_out.valid.sum()) >= 6

    path = str(tmp_path / "planes.pt")
    save_state(path, st, step=1)
    like = prod_rx_init_planes(BENCH, 3, "cpu")
    restored, step = restore_state(path, like=like)
    assert step == 1 and type(restored) is tuple
    assert restored[4].dtype == torch.bfloat16
    for x, y in zip(restored, st):
        assert torch.equal(x, y)
    state, out = run(restored, parts[1])
    _assert_equal(out, full_out)
    for x, y in zip(state, full_state):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_file_loads_weights_only(tmp_path):
    state = prod_rx_init(TCFG, (2,), device="cpu")
    path = str(tmp_path / "st.pt")
    save_state(path, state, step=5)
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 5
    enc = payload["state"]
    assert enc["type"] == "ProdRxState"
    assert enc["fields"] == ["phase", "fir_tail", "decim_prev"]
    # complex leaves are stored as their real and imaginary planes
    assert enc["children"][0]["leaf"] == "complex"
    assert enc["children"][0]["re"].dtype == torch.float32
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("like", ["planes", "channels", "gated", "rx"])
def test_restore_with_mismatched_like_raises(tmp_path, like):
    path = str(tmp_path / "st.pt")
    save_state(path, prod_rx_init(TCFG, (2,), device="cpu"))
    other = {"planes": lambda: prod_rx_init_planes(TCFG, 2, "cpu"),
             "channels": lambda: prod_rx_init(TCFG, (3,), device="cpu"),
             "gated": lambda: prod_rx_gated_init(TCFG, 2, "cpu"),
             "rx": lambda: rx_init(TCFG, (2,), device="cpu")}[like]()
    with pytest.raises(ValueError, match="checkpoint structure"):
        restore_state(path, like=other)


def _flat(tree):
    """The tensor leaves of nested tuples, in order."""
    for x in tree:
        yield from _flat(x) if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kind", ["gated", "rx"])
def test_checkpoint_roundtrip_other_states(tmp_path, kind):
    """GatedRxState (bf16 planes, int16 PCM) and the faithful RxState
    (complex and int32 leaves) come back as they went, without ``like``
    too."""
    if kind == "gated":
        state = prod_rx_gated_init(BENCH, 3, "cpu")
        state = state._replace(pcm_prev=torch.arange(
            3 * BENCH.frame_size, dtype=torch.int16).reshape(3, -1))
    else:
        state = rx_init(TCFG, (3,), device="cpu")
        state = state._replace(rx_timing=torch.tensor([1, 2, 3],
                                                      dtype=torch.int32))
    path = str(tmp_path / "st.pt")
    save_state(path, state, step=7)
    for like in (None, state):
        got, step = restore_state(path, like=like, device="cpu")
        assert step == 7
        assert type(got) is type(state)
        assert type(got) in (GatedRxState, RxState)
        assert type(got[0]) is type(state[0])
        for x, y in zip(_flat(got), _flat(state)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_metrics_aggregator_counts():
    m = MetricsAggregator()
    s = m.summary()
    assert s["packets"] == 0 and s["blocks"] == 0
    assert s["mean_matches"] == 0.0
    blk = ProdRxOut(valid=torch.tensor([True, False, True, False]),
                    bits=torch.zeros((4, 8), dtype=torch.uint8),
                    matches=torch.tensor([128, 3, 126, 0], dtype=torch.int32),
                    lag=torch.zeros(4, dtype=torch.int32),
                    timing_phase=torch.zeros(4, dtype=torch.int32),
                    peak=torch.zeros(4), energy=torch.zeros(4),
                    cfo_hz=torch.tensor([1.0, 9.0, 3.0, 9.0]),
                    eq_error=torch.tensor([0.5, 9.0, 0.25, 9.0]))
    m.update(blk)
    m.update(blk._replace(valid=torch.zeros(4, dtype=torch.bool)))
    s = m.summary()
    assert s == {"blocks": 2, "packets": 2, "mean_cfo_hz": 2.0,
                 "mean_eq_error": 0.375, "mean_matches": 127.0}
    assert m.channels_seen == 4


def test_log_compiles_logs_builds_not_cached_calls(tmp_path, monkeypatch,
                                                   caplog):
    """A kernel-library build inside the block is logged; the same call
    once the library exists, and a CPU step, log nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def fake_compile(lib_path, csrc, flags):
        lib_path.write_bytes(b"fake library")
        return ""

    monkeypatch.setattr(_build, "_compile", fake_compile)
    with log_compiles() as events:
        _build.build(defines=("SC_D=124",))
    assert len(events) == 1 and "built" in events[0]
    assert "compile: built" in caplog.text
    state = prod_rx_init_planes(BENCH, 2, "cpu")
    with log_compiles() as events:
        _build.build(defines=("SC_D=124",))
        prod_rx_batch(BENCH, state, torch.zeros((1, 2, BENCH.frame_size),
                                                dtype=torch.int16),
                      fuse_frontend=True)
    assert events == []
    assert not _build.COMPILE_LISTENERS


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as log_dir:
        torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        assert json.load(f)["traceEvents"]


def test_throughput_meter():
    meter = ThroughputMeter()
    meter.add(8000)
    meter.add(8000)
    s = meter.summary()
    assert s["samples"] == 16000 and s["wall_s"] >= 0
    assert s["samples_per_sec"] > 0
    assert meter.summary(fs=1e15)["realtime_channels"] == 0
