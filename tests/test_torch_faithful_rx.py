"""PyTorch port: the faithful receiver (``modem/rx.py``) against the C
reference's fixtures and the JAX package's ``rx_stream``, on the CPU.

* On the C harness's TX stream ``tx_pcm`` (``tests/golden/
  reference.npz``) the port reproduces ``rxt_*`` exactly (valid,
  max_index, matches, the bits of valid frames, the final rx_timing;
  max_value and mean within rtol 1e-3 as ``tests/test_rx_golden.py``),
  and ``f20_rxt_*`` (the C built with FOFFSET = 20 Hz) but for
  ``matches`` on frame 11, an invalid frame where the JAX package gives
  77 and the C 78: there the port equals the JAX package.
* Against the JAX package's ``rx_stream`` (XLA on the CPU): the golden
  stream delayed on 4 channels with the state carried across two calls
  (and across the packages by ``interop``), a noisy stream (the port's
  TX through its channel, 10 dB, 15 Hz), ``blocked=32``, and eq7 and
  alt_9600 on the port's own TX.  Valid, max_index and matches
  equal, the bits equal on valid frames; max_value and mean within 1e-5
  of their scale, eof_cost within 1e-4 of its scale (the miss branch's
  31 steps of the recursion amplify the last bit); the state within 1e-5
  of its scale.
* Batched equals single channel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx as jrx
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.channel import channel as tchannel
from singlecarrier_tpu_torch.device import to_int16
from singlecarrier_tpu_torch.modem import rx as trx
from singlecarrier_tpu_torch.modem.tx import tx_stream as ttx_stream
from singlecarrier_tpu_torch.ops._build import NUMEROLOGIES

SHIFTS = (0, 377, 1203, 1878)
HALF = 8                    # frames a call: both calls and the noisy
                            # stream share one compiled JAX function
JAX_FN = jrx.make_rx_stream_fn(CFG, batched=True)


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _delayed(pcm, shifts, n):
    """[C, nb, n] int16: ``pcm`` delayed by ``shifts``, zero-padded."""
    nb = -(-(len(pcm) + max(shifts)) // n) + 1
    x = np.zeros((len(shifts), nb * n), np.int16)
    for c, s in enumerate(shifts):
        x[c, s:s + len(pcm)] = pcm
    return x.reshape(len(shifts), nb, n)


def _jax_run(cfg, state, frames, **kw):
    """JAX's batched ``rx_stream`` over [C, nf, n]; numpy leaves."""
    fn = jax.jit(jax.vmap(lambda s, f: jrx.rx_stream(cfg, s, f, **kw)))
    st, out = fn(state, jnp.asarray(frames))
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, out)


def _port_run(cfg, state, frames, **kw):
    """The port's ``rx_stream`` over [C, nf, n] (frames first inside)."""
    st, out = trx.rx_stream(_tcfg(cfg), state,
                            torch.from_numpy(frames).transpose(0, 1), **kw)
    return st, type(out)(*(v.transpose(0, 1).numpy() for v in out))


def _scale_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _agree(t, j, min_valid=1):
    """Decisions equal; the bits on valid frames; stats by scale."""
    v = np.asarray(j.valid)
    assert int(v.sum()) >= min_valid
    assert np.array_equal(t.valid, v)
    assert np.array_equal(t.max_index, j.max_index)
    assert np.array_equal(t.matches, j.matches)
    assert np.array_equal(t.bits[v], j.bits[v])
    _scale_close(t.max_value, j.max_value, 1e-5)
    _scale_close(t.mean, j.mean, 1e-5)
    _scale_close(t.eof_cost, j.eof_cost, 1e-4)


def _state_close(t, j):
    for a, b in zip(interop.rx_state_to_numpy(t), j):
        assert a.dtype == np.asarray(b).dtype
        if a.dtype == np.int32:
            assert np.array_equal(a, b)
        else:
            _scale_close(a, b, 1e-5)


# ------------------------------------------------ (d) the C fixtures

@pytest.fixture(scope="module")
def harness_frames(golden):
    pcm = golden["tx_pcm"].astype(np.int16)
    nf = len(pcm) // CFG.frame_size
    return pcm[:nf * CFG.frame_size].reshape(1, nf, CFG.frame_size)


@pytest.fixture(scope="module")
def jax_f20(harness_frames):
    """JAX's run at FOFFSET = 20 Hz (the knife edge of frame 11)."""
    return _jax_run(CFG, jrx.rx_init(CFG, (1,)), harness_frames,
                    freq_offset=20.0)[1]


@pytest.mark.parametrize("tag", ["rxt", "f20_rxt"])
def test_rx_stream_reproduces_the_c_fixture(golden, harness_frames, tag,
                                            request):
    fo = 20.0 if tag.startswith("f20") else 0.0
    state = trx.rx_init(_tcfg(CFG), (1,), device="cpu")
    st, out = _port_run(CFG, state, harness_frames, freq_offset=fo)
    out = type(out)(*(x[0] for x in out))
    assert out.valid.dtype == np.bool_ and out.bits.dtype == np.uint8
    assert out.matches.dtype == out.max_index.dtype == np.int32
    valid = golden[f"{tag}_valid"].astype(bool)
    assert np.array_equal(out.valid, valid)
    assert np.array_equal(out.max_index, golden[f"{tag}_max_index"])
    assert np.array_equal(out.bits[valid], golden[f"{tag}_bits"][valid])
    assert int(st.rx_timing[0]) == golden[f"{tag}_rx_timing"][-1]
    assert np.allclose(out.max_value, golden[f"{tag}_max_value"],
                       rtol=1e-3, atol=1e-3)
    assert np.allclose(out.mean, golden[f"{tag}_mean"], rtol=1e-3,
                       atol=1e-3)
    c_matches = golden[f"{tag}_matches"]
    if tag == "rxt":
        assert np.array_equal(out.matches, c_matches)
    else:
        jax_matches = request.getfixturevalue("jax_f20").matches[0]
        assert np.array_equal(out.matches, jax_matches)
        assert np.array_equal(out.matches[valid], c_matches[valid])
        # the one place the JAX package leaves the C: frame 11, invalid
        differ = np.nonzero(jax_matches != c_matches)[0]
        assert differ.tolist() == [11] and not valid[11]


# --------------------------------------------------- (e) against JAX

def _spread(x, n, rng):
    """[C, nb, n] int16: each channel of ``x`` [C, samples] delayed by
    its own offset in [0, n), zero-padded."""
    C = x.shape[0]
    shifts = rng.integers(0, n, C)
    nb = -(-(x.shape[1] + n) // n) + 1
    out = np.zeros((C, nb * n), np.int16)
    for c, d in enumerate(shifts):
        out[c, d:d + x.shape[1]] = x[c]
    return out.reshape(C, nb, n)


@pytest.fixture(scope="module")
def noisy_frames():
    """[4, HALF, n]: 4 channels x 4 packets of the port's TX through its
    channel, 10 dB, 15 Hz."""
    rng = np.random.default_rng(31)
    bits = rng.integers(0, 2, (4, 4, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    gen = torch.Generator().manual_seed(31)
    x = to_int16(tchannel(gen, ttx_stream(_tcfg(CFG), bits, device="cpu"),
                          snr_db=10.0, freq_hz=15.0, fs=CFG.fs,
                          device="cpu"))
    return _spread(x.numpy(), CFG.frame_size, rng)[:, :HALF]


def _own_tx_frames(cfg):
    """2 channels x 3 packets of the port's TX at ``cfg``'s numerology."""
    rng = np.random.default_rng(32)
    bits = rng.integers(0, 2, (2, 3, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    x = ttx_stream(_tcfg(cfg), bits, device="cpu").numpy()
    return _spread(x, cfg.frame_size, rng)


@pytest.fixture(scope="module")
def golden_delayed(golden):
    return _delayed(golden["tx_pcm"].astype(np.int16), SHIFTS, CFG.frame_size)


def test_delayed_channels_and_the_state_across_calls(golden_delayed):
    """Two calls of ``make_rx_stream_fn(batched=True)`` on the golden
    stream delayed on 4 channels: the port's state after the first equal
    to JAX's; the second call run from JAX's state carried over by
    ``interop`` and equal to JAX's second call."""
    first, second = (golden_delayed[:, :HALF],
                     golden_delayed[:, HALF:2 * HALF])
    fj = JAX_FN
    ft = trx.make_rx_stream_fn(_tcfg(CFG), batched=True)
    sj, oj = fj(jrx.rx_init(CFG, (len(SHIFTS),)), jnp.asarray(first))
    st, ot = ft(trx.rx_init(_tcfg(CFG), (len(SHIFTS),), device="cpu"),
                torch.from_numpy(first))
    sj = jax.tree.map(np.asarray, sj)
    _agree(type(ot)(*(x.numpy() for x in ot)), jax.tree.map(np.asarray, oj))
    _state_close(st, sj)
    st = interop.rx_state_from_numpy(sj, device="cpu")
    assert all(a.dtype == b.dtype for a, b in zip(
        st, trx.rx_init(_tcfg(CFG), device="cpu")))
    sj2, oj2 = fj(jax.tree.map(jnp.asarray, sj), jnp.asarray(second))
    st2, ot2 = ft(st, torch.from_numpy(second))
    _agree(type(ot2)(*(x.numpy() for x in ot2)),
           jax.tree.map(np.asarray, oj2), min_valid=4)
    _state_close(st2, jax.tree.map(np.asarray, sj2))


@pytest.mark.parametrize("case", ["noisy", "blocked32", "eq7", "alt_9600"])
def test_rx_stream_matches_jax(case, golden_delayed, request):
    """One call each: the noisy stream, the blocked equalizer (B = 32) on
    the delayed golden stream, and the two numerologies that change the
    equalizer's and the front-end's shapes, on the port's own TX."""
    cfg, kw = CFG, {}
    if case == "noisy":
        frames = request.getfixturevalue("noisy_frames")
    elif case == "blocked32":
        frames, kw = golden_delayed, {"blocked": 32}
    else:
        cfg = CFG.replace(**NUMEROLOGIES[case])
        frames = _own_tx_frames(cfg)
    C = frames.shape[0]
    if case == "noisy":
        sj, oj = JAX_FN(jrx.rx_init(cfg, (C,)), jnp.asarray(frames))
        sj, oj = jax.tree.map(np.asarray, (sj, oj))
    else:
        sj, oj = _jax_run(cfg, jrx.rx_init(cfg, (C,)), frames, **kw)
    st, ot = _port_run(cfg, trx.rx_init(_tcfg(cfg), (C,), device="cpu"),
                       frames, **kw)
    _agree(ot, oj, min_valid=C)
    _state_close(st, sj)


def test_batched_equals_single_channel(noisy_frames):
    """``make_rx_stream_fn(batched=True)`` on 3 channels of the noisy
    stream against the unbatched function on one of them; ``rx_frame``
    is the stream's step."""
    frames = noisy_frames[:3]
    tcfg = _tcfg(CFG)
    sb, ob = trx.make_rx_stream_fn(tcfg, batched=True)(
        trx.rx_init(tcfg, (3,), device="cpu"), torch.from_numpy(frames))
    assert ob.valid.shape == frames.shape[:2]
    for c in (1,):
        ss, os_ = trx.make_rx_stream_fn(tcfg)(
            trx.rx_init(tcfg, device="cpu"), torch.from_numpy(frames[c]))
        _agree(type(os_)(*(x.numpy() for x in os_)),
               type(ob)(*(x[c].numpy() for x in ob)))
        for a, b in zip(ss, sb):
            _scale_close(a.numpy(), b[c].numpy(), 1e-5)
    st = trx.rx_init(tcfg, (3,), device="cpu")
    for k in range(2):
        st, out = trx.rx_frame(tcfg, st, torch.from_numpy(frames[:, k]))
        assert np.array_equal(out.matches.numpy(), ob.matches[:, k].numpy())
