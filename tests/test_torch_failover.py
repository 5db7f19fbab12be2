"""PyTorch port: failure detection and elastic recovery
(``singlecarrier_tpu_torch.runtime.failover``), the five cases of
``tests/test_failover.py`` on the CPU, plus ``health_check`` on the
plane state.

The recovery contract: the demod step is state-in/state-out, so
restore-and-replay after any fault reproduces the fault-free outputs --
here every output field equal to the port's clean run, to the bit.
The stream: three packets of the port's TX (numpy bits, seed 33) on 2
channels.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as JCFG
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (prod_rx_init, prod_rx_init_planes,
                                           tx_stream)
from singlecarrier_tpu_torch.runtime import StreamDemodulator
from singlecarrier_tpu_torch.runtime.failover import (
    ElasticDemodulator,
    Heartbeat,
    failed_processes,
    health_check,
    monitor_heartbeats,
)

CFG = interop.config_from_dict(dataclasses.asdict(JCFG))
N_CH = 2


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(33)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, bits, flush_gap=True, device="cpu").numpy()
    n_blocks = -(-len(pcm) // CFG.frame_size)
    buf = np.zeros(n_blocks * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    blocks = buf.reshape(n_blocks, CFG.frame_size)
    return np.broadcast_to(
        blocks[:, None, :], (n_blocks, N_CH, CFG.frame_size)).copy()


@pytest.fixture(scope="module")
def clean_outputs(stream):
    demod = StreamDemodulator(CFG, n_channels=N_CH, descramble=False,
                              metrics=False, device="cpu")
    outs = [demod.push(b) for b in stream]
    assert int(sum(o.valid.sum() for o in outs)) == 3 * N_CH
    return outs


def _assert_matches(outs, clean_outputs):
    assert len(outs) == len(clean_outputs)
    for out, ref in zip(outs, clean_outputs):
        for x, y in zip(out, ref):
            assert x.dtype == y.dtype and torch.equal(x, y)


def _elastic(tmp_path, **kw):
    return ElasticDemodulator(
        CFG, N_CH, checkpoint_path=os.path.join(tmp_path, "ckpt.pt"),
        descramble=False, device="cpu", **kw)


def test_health_check_flags_nonfinite():
    state = prod_rx_init(CFG, (N_CH,), device="cpu")
    assert health_check(state) == 0
    tail = state.fir_tail.clone()
    tail[0, 3] = complex(float("nan"), 0.0)
    assert health_check(state._replace(fir_tail=tail)) == 1
    tail[1, 0] = complex(0.0, float("inf"))     # a bad imaginary part
    assert health_check(state._replace(fir_tail=tail)) == 2


def test_health_check_plane_state():
    """The plane 5-tuple: f32 planes, a bf16 inf in the decim planes;
    integer leaves count 0."""
    cfg = CFG.replace(decim_dtype="bf16")
    planes = prod_rx_init_planes(cfg, N_CH, "cpu")
    assert planes[4].dtype == torch.bfloat16
    assert health_check(planes) == 0
    dprev = planes[4].clone()
    dprev[2, 1, 0, 7] = float("inf")
    assert health_check((*planes[:4], dprev)) == 1
    phase_r = planes[0].clone()
    phase_r[1] = float("nan")
    assert health_check((phase_r, *planes[1:4], dprev)) == 2
    assert health_check((torch.zeros(3, dtype=torch.int16), dprev)) == 1


def test_recovers_from_transient_source_fault(stream, clean_outputs,
                                              tmp_path):
    faulted = {"done": False}

    def source(i):
        if i == 3 and not faulted["done"]:
            faulted["done"] = True
            raise IOError("injected transient ingest fault")
        return stream[i]

    ed = _elastic(tmp_path, checkpoint_every=2)
    outs = ed.run(source, n_blocks=len(stream))
    assert ed.recoveries == 1
    _assert_matches(outs, clean_outputs)


def test_recovers_from_state_corruption(stream, clean_outputs, tmp_path):
    """Poison the carried state mid-stream; the health check must trip
    and restore-and-replay must reproduce the clean decode."""
    ed = _elastic(tmp_path, checkpoint_every=2)
    outs = []
    for i in range(len(stream)):
        if i == 3:
            # the downmix phasor is multiplicative carry: a NaN here
            # poisons every subsequent block's state until recovery
            phase = ed.state.phase.clone()
            phase[1] = complex(float("nan"), 0.0)
            ed.state = ed.state._replace(phase=phase)
        outs.append(ed.step(lambda k: stream[k]))
    assert ed.recoveries >= 1
    _assert_matches(outs, clean_outputs)


def test_persistent_fault_raises(stream, tmp_path):
    def source(i):
        if i == 2:
            raise IOError("deterministic poison")
        return stream[i]

    ed = _elastic(tmp_path, max_retries=2)
    with pytest.raises(IOError):
        ed.run(source, n_blocks=len(stream))
    assert ed.recoveries == 2


def test_heartbeat_monitor(tmp_path):
    hb_dir = str(tmp_path / "hb")
    assert Heartbeat(hb_dir).process_id == 0    # no process group
    hb0 = Heartbeat(hb_dir, process_id=0)
    hb1 = Heartbeat(hb_dir, process_id=1)
    hb0.beat(step=7)
    hb1.beat(step=7)
    recs = monitor_heartbeats(hb_dir, timeout_s=30.0)
    assert set(recs) == {0, 1}
    assert not any(r["stale"] for r in recs.values())
    assert failed_processes(hb_dir, timeout_s=30.0) == []
    # age out process 1 by back-dating its stamp
    p1 = os.path.join(hb_dir, "hb_1.json")
    with open(p1) as f:
        rec = json.load(f)
    rec["time"] -= 120.0
    with open(p1, "w") as f:
        json.dump(rec, f)
    assert failed_processes(hb_dir, timeout_s=30.0) == [1]
