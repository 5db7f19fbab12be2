"""PyTorch port: the XLA production RX (``prod_rx_frame``,
``prod_rx_stream``, ``prod_rx_backend``, ``make_prod_rx_fn(pallas=
False)``) against the JAX package's, on the CPU.

Inputs: the golden stream (``tests/golden/reference.npz``) and a stream
of the JAX package's own TX (scrambled, flushed gap) through its channel
with a 15 Hz carrier offset and no noise, each on C = 4 channels at
different delays, cast to int16 as ``astype(int16)`` does.  The state is
carried across two calls.  Held to the North star's criterion:
identical valid, bits on valid blocks, lag and phase on detected blocks,
|dcfo| < 0.5 Hz, |deq_error| < 2e-3; matches equal; the carried state
within 1e-5 of its scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.channel import channel as jchannel
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream as jtx_stream
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import rx_production as trx

SHIFTS = (0, 377, 1203, 1878)
C = len(SHIFTS)


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _channels(pcm, n=CFG.frame_size):
    """[C, nb, n] int16: ``pcm`` delayed by SHIFTS, zero-padded."""
    nb = -(-(len(pcm) + max(SHIFTS)) // n) + 1
    x = np.zeros((C, nb * n), np.int16)
    for c, s in enumerate(SHIFTS):
        x[c, s:s + len(pcm)] = pcm
    return x.reshape(C, nb, n)


@pytest.fixture(scope="module")
def golden_frames(golden):
    return _channels(golden["tx_pcm"].astype(np.int16))


@pytest.fixture(scope="module")
def channel_frames():
    """Three scrambled packets of the JAX TX, 15 Hz CFO, no noise; the
    sent bits."""
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    x = jax.jit(lambda b: jchannel(
        None, jtx_stream(CFG, b, scramble=True, flush_gap=True),
        freq_hz=15.0, fs=CFG.fs).astype(jnp.int16))(jnp.asarray(bits))
    return _channels(np.asarray(x)), bits


def _np_out(out):
    return type(out)(*(np.asarray(v) for v in out))


def _agree(t, j, detected_min=1):
    """The North star's criterion between two ProdRxOut of numpy leaves."""
    v = j.valid
    assert int(v.sum()) >= detected_min
    assert np.array_equal(t.valid, v)
    assert np.array_equal(t.bits[v], j.bits[v])
    assert np.array_equal(t.lag[v], j.lag[v])
    assert np.array_equal(t.timing_phase[v], j.timing_phase[v])
    assert np.array_equal(t.matches, j.matches)
    assert np.abs(t.cfo_hz[v] - j.cfo_hz[v]).max() < 0.5
    assert np.abs(t.eq_error[v] - j.eq_error[v]).max() < 2e-3


def _state_close(t, j):
    for a, b in zip(interop.state_to_numpy(t), jax.tree.map(np.asarray, j)):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("knobs", [
    {}, {"hunt_dtype": "int8", "ls_refit_symbols": 128},
    {"frac_timing": True}, {"hunt_dtype": "f32", "alpha": 0.50},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_batched_fn_matches_jax_on_golden(golden_frames, knobs):
    """``make_prod_rx_fn(batched=True)``: state [C], frames [C, n_frames,
    n], two calls carrying the state.  The golden stream's packets are
    all found (10 per channel, 11 where a preamble sits at a seam)."""
    cfg = CFG.replace(**knobs)
    half = golden_frames.shape[1] // 2
    fj = jrx.make_prod_rx_fn(cfg, batched=True)
    ft = trx.make_prod_rx_fn(_tcfg(cfg), batched=True)
    sj = jrx.prod_rx_init(cfg, (C,))
    st = trx.prod_rx_init(_tcfg(cfg), (C,), device="cpu")
    for part in (golden_frames[:, :half], golden_frames[:, half:]):
        sj, oj = fj(sj, jnp.asarray(part))
        st, ot = ft(st, torch.from_numpy(part))
        assert ot.valid.shape == (C, part.shape[1])
        _agree(_np_out(ot), _np_out(oj))
    _state_close(st, sj)


def test_frame_stream_and_unbatched_fn_match_jax(channel_frames):
    """One channel through ``prod_rx_frame`` block by block, through
    ``prod_rx_stream`` and through ``make_prod_rx_fn()`` (each carrying
    the state across two calls), against the JAX functions; with the
    descramble the bits are the sent payload."""
    frames, bits = channel_frames
    tcfg = _tcfg(CFG)
    x = frames[1]
    half = len(x) // 2
    sj, oj = jrx.make_prod_rx_fn(CFG, descramble=True)(
        jrx.prod_rx_init(CFG), jnp.asarray(x))
    oj = _np_out(oj)
    assert int(oj.valid.sum()) == 3
    assert np.array_equal(oj.bits[oj.valid],
                          bits.reshape(3, CFG.bits_per_frame))

    st = trx.prod_rx_init(tcfg, device="cpu")
    outs = []
    for blk in x:
        st, o = trx.prod_rx_frame(tcfg, st, torch.from_numpy(blk),
                                  descramble=True)
        outs.append(o)
    _agree(trx.ProdRxOut(*(torch.stack(v).numpy() for v in zip(*outs))),
           oj, 3)
    _state_close(st, sj)

    for fn in (lambda s, f: trx.prod_rx_stream(tcfg, s, f),
               trx.make_prod_rx_fn(tcfg)):
        st = trx.prod_rx_init(tcfg, device="cpu")
        parts = []
        for part in (x[:half], x[half:]):
            st, o = fn(st, torch.from_numpy(part))
            parts.append(o)
        _agree(trx.ProdRxOut(*(torch.cat(v).numpy() for v in zip(*parts))),
               oj, 3)
        _state_close(st, sj)


def test_batched_fn_matches_jax_on_tx_channel_stream(channel_frames):
    frames, _ = channel_frames
    tcfg = _tcfg(CFG)
    sj, oj = jrx.make_prod_rx_fn(CFG, batched=True)(
        jrx.prod_rx_init(CFG, (C,)), jnp.asarray(frames))
    st, ot = trx.make_prod_rx_fn(tcfg, batched=True)(
        trx.prod_rx_init(tcfg, (C,), device="cpu"),
        torch.from_numpy(frames))
    _agree(_np_out(ot), _np_out(oj), 3 * C)
    assert np.abs(np.asarray(oj.cfo_hz)[np.asarray(oj.valid)]
                  - 15.0).max() < 1.0
    _state_close(st, sj)


@pytest.mark.parametrize("descramble", [False, True])
def test_backend_matches_jax(channel_frames, descramble):
    """``prod_rx_backend`` alone on the same filtered block and carried
    phases (the port's, two blocks into the stream): decisions, the
    decimated phases equal, energy and peak within 1e-5."""
    frames, _ = channel_frames
    cfg, tcfg = CFG, _tcfg(CFG)
    st, _ = trx.prod_rx_stream(tcfg, trx.prod_rx_init(tcfg, (C,), "cpu"),
                               torch.from_numpy(frames[:, :2]).transpose(
                                   0, 1))
    taps = trx.rrc_taps(tcfg.alpha, tcfg.ntaps)
    x = torch.from_numpy(frames[:, 2]).float() / tcfg.tx_amplitude
    raw, _ = trx.mix_block(x, st.phase, -tcfg.center, tcfg.fs)
    filt, _ = trx.fir_block(taps, tcfg.fir_gain, st.fir_tail, raw)
    dprev, filt = st.decim_prev.numpy(), filt.numpy()
    dj, oj = jax.jit(jax.vmap(lambda d, f: jrx.prod_rx_backend(
        cfg, d, f, descramble=descramble)))(dprev, filt)
    dt, ot = trx.prod_rx_backend(tcfg, torch.from_numpy(dprev),
                                 torch.from_numpy(filt),
                                 descramble=descramble)
    oj, ot = _np_out(oj), _np_out(ot)
    _agree(ot, oj)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    for a, b in ((ot.energy, oj.energy), (ot.peak, oj.peak)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_knobs_the_xla_path_does_not_read_run_and_hunt_norm_raises(
        golden_frames):
    """The kernel knobs leave the XLA path's decisions as they are;
    hunt_norm energy and none, which raised here until the port took
    them, run and find the golden packets the espan statistic finds."""
    tcfg = _tcfg(CFG)
    part = torch.from_numpy(golden_frames[:2, :4])
    fn = trx.make_prod_rx_fn(tcfg, batched=True)
    _, ref = fn(trx.prod_rx_init(tcfg, (2,), device="cpu"), part)
    for knob in ({"cfo_dtype": "bf16"}, {"ls_gram": "direct"},
                 {"ls_bvec": "matmul"}, {"frontend_dtype": "f32"},
                 {"decim_dtype": "bf16"}):
        cfg = tcfg.replace(**knob)
        _, out = trx.make_prod_rx_fn(cfg, batched=True)(
            trx.prod_rx_init(cfg, (2,), device="cpu"), part)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), knob
    assert bool(ref.valid.any())
    for norm in ("energy", "none"):
        cfg = tcfg.replace(hunt_norm=norm)
        _, out = trx.make_prod_rx_fn(cfg, batched=True)(
            trx.prod_rx_init(cfg, (2,), device="cpu"), part)
        v = ref.valid
        assert torch.equal(out.valid, v), norm
        assert torch.equal(out.bits[v], ref.bits[v]), norm
