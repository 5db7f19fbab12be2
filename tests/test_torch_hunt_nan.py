"""PyTorch port: the hunt on NaN windows, held to the JAX kernel.

A NaN cannot come from int16 PCM with a finite state; it comes from a
corrupted or restored state (the case of ``runtime/failover`` and
``validate.checkify_step``).  The JAX kernel (``decode_pallas.py:
858-876``) takes one max per decimation phase, so a phase whose
statistic holds a NaN never wins; under ``hunt_norm="espan"`` one NaN in
a row's window poisons every phase, and the row keeps the initial best:
lag 0, phase 0, peak 2 (-1) in the peak's units.  Its int8 quantizer
casts a NaN to 0 (``fused_rx.py:89-91``).

The same int16 frames and the same numpy plane state go through JAX's
``prod_rx_batch(fuse_frontend=True)`` in interpret mode and the port's
plain ``prod_rx_batch(fuse_frontend=True)`` and ``hunt_ref`` on the CPU,
at the bench operating point (int8 operand) under ``hunt_norm`` "espan"
and "none", and at the library default (bf16 operand): lag, phase and
peak equal on every row.  Channel 0 is clean, channel 1 carries a NaN
phase (its planes are NaN from the front-end on), channel 2 one NaN
sample in its carried decim planes, on the phase and symbols that block
0's winning lag reads, channel 3 two.  Three interpret-mode calls.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.modem.rx_production import prod_rx_batch as jbatch
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import prod_rx_batch
from singlecarrier_tpu_torch.ops.decode import hunt_ref
from singlecarrier_tpu_torch.ops.frontend import frontend_decim
from singlecarrier_tpu_torch.ops.fused_rx import _advances

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
CASES = {"bench_espan": BENCH,
         "bench_none": BENCH.replace(hunt_norm="none"),
         "default_espan": CFG}
B, C = 3, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    in several worker processes at once, and its spawned ranks take
    cores of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """[B, C, frame_size] int16: two packets of JAX's TX on every
    channel."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (2, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n = CFG.frame_size
    buf = np.zeros(B * n, np.int16)
    buf[:min(len(pcm), B * n)] = pcm[:B * n]
    return np.broadcast_to(buf.reshape(B, 1, n), (B, C, n)).copy()


def _state(cfg):
    """The plane state as numpy: random unit phases and tails, noise in
    the carried planes (in ``cfg.decim_dtype``), and the NaNs."""
    rng = np.random.default_rng(5)
    ph = rng.uniform(0, 2 * np.pi, C)
    halo = cfg.ntaps - 1
    dprev = rng.normal(0.0, 0.3, (cfg.cycles, 2, C, cfg.symbols_per_block))
    ddt = jnp.bfloat16 if cfg.decim_dtype == "bf16" else jnp.float32
    dprev = np.array(jnp.asarray(dprev, jnp.float32).astype(ddt))
    st = [np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32),
          (rng.normal(0.0, 0.1, (C, halo))).astype(np.float32),
          (rng.normal(0.0, 0.1, (C, halo))).astype(np.float32), dprev]
    st[0][1] = np.nan                   # a NaN phase
    st[4][3, 0, 2, 330] = np.nan        # one NaN sample, phase 3, real
    st[4][3, 1, 3, 340] = np.nan        # and two on channel 3
    st[4][1, 0, 3, 20] = np.nan
    return tuple(st)


@pytest.mark.parametrize("case", list(CASES))
def test_hunt_on_nan_windows_matches_jax(frames, case):
    cfg = CASES[case]
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    st = _state(cfg)
    _, jo = jbatch(cfg, tuple(jnp.asarray(x) for x in st),
                   jnp.asarray(frames), descramble=False,
                   fuse_frontend=True, interpret=True)
    j = {f: np.asarray(getattr(jo, f)) for f in ("lag", "timing_phase",
                                                  "peak")}

    planes = interop.planes_from_numpy(st, device="cpu")
    pcm = torch.from_numpy(frames)
    _, to = prod_rx_batch(tcfg, planes, pcm, descramble=False,
                          fuse_frontend=True)
    dk = frontend_decim(tcfg, pcm, *planes[:4], _advances(tcfg, B,
                                                          pcm.device)[1])
    hl, hp, hq = hunt_ref(tcfg, dk, planes[4])
    ports = {"prod_rx_batch": (to.lag.numpy(), to.timing_phase.numpy(),
                               to.peak.numpy()),
             "hunt_ref": (hl.reshape(B, C).numpy(),
                          hp.reshape(B, C).numpy(),
                          hq.reshape(B, C).numpy())}
    for what, (lag, ph, peak) in ports.items():
        assert np.array_equal(lag, j["lag"]), (what, lag, j["lag"])
        assert np.array_equal(ph, j["timing_phase"]), (what, ph)
        assert np.array_equal(peak, j["peak"]), (what, peak, j["peak"])

    # the rule itself: the NaN-phase channel keeps the initial best
    # wherever a NaN reaches every phase's statistic
    scale = (np.float32(1.0 / cfg.hunt_int8_scale ** 2)
             if cfg.hunt_dtype == "int8" else np.float32(1.0))
    if cfg.hunt_norm == "espan":
        assert (j["lag"][:, 1] == 0).all() and (j["timing_phase"][:, 1]
                                                == 0).all()
        assert (j["peak"][:, 1] == np.float32(-2.0) * scale).all()
        # one NaN sample in block 0's window skips every phase there
        assert j["lag"][0, 2] == 0 and j["peak"][0, 2] < 0
    else:
        # the int8 operand takes a NaN as 0 and no energy is formed:
        # channel 2 still finds the packet's preamble at block 0
        assert j["peak"][0, 2] > 0
