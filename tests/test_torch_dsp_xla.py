"""PyTorch port: the DSP modules of the XLA production path against the
JAX package's, on seeded numpy inputs (CPU).

``dsp/mixer`` (``mixer_init_phase``, ``mix_block``), ``dsp/fir``,
``dsp/fftops`` (``estimate_cfo`` both methods, ``wipeoff_rotation``),
``utils/linalg.chol_solve_hermitian``, ``adaptive/ls_equalizer`` and
``scramble``.  Tolerances: the true-f32 paths within 1e-5 relative to
the output's scale; the bf16 CFO spectrum within 1e-5 of its peak with
the same peak bin; dibits, masks and decisions equal.  The JAX
equalizer functions take one channel and are ``vmap``ped here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu import scramble as jscr
from singlecarrier_tpu.adaptive import ls_equalizer as jls
from singlecarrier_tpu.constants import PREAMBLE_VALUES, rrc_taps
from singlecarrier_tpu.dsp import fftops as jfft
from singlecarrier_tpu.dsp import fir as jfir
from singlecarrier_tpu.dsp import mixer as jmix
from singlecarrier_tpu.utils import linalg as jlin
from singlecarrier_tpu_torch import scramble as tscr
from singlecarrier_tpu_torch.adaptive import ls_equalizer as tls
from singlecarrier_tpu_torch.dsp import fftops as tfft
from singlecarrier_tpu_torch.dsp import fir as tfir
from singlecarrier_tpu_torch.dsp import mixer as tmix
from singlecarrier_tpu_torch.utils import linalg as tlin

RTOL = 1e-5


def _c64(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale


# ------------------------------------------------------------- mixer

@pytest.mark.parametrize("real_in", [True, False], ids=["real", "complex"])
def test_mixer_matches_jax(real_in):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 1880)).astype(np.float32) if real_in
         else _c64(rng, (3, 1880)))
    ph = np.exp(1j * rng.uniform(-3, 3, 3)).astype(np.complex64)
    assert np.array_equal(tmix.mixer_init_phase((3,), "cpu").numpy(),
                          np.asarray(jmix.mixer_init_phase((3,))))
    for f in (-1100.0, 1100.0):
        yj, pj = jmix.mix_block(jnp.asarray(x), jnp.asarray(ph), f, 8000.0)
        yt, pt = tmix.mix_block(_t(x), _t(ph), f, 8000.0)
        _close(yt.numpy(), yj)
        _close(pt.numpy(), pj)
        assert np.abs(np.abs(pt.numpy()) - 1).max() < 1e-6


# --------------------------------------------------------------- FIR

def test_fir_matrix_and_halo_match_jax():
    taps = rrc_taps(0.35, 49)
    key = tuple(np.asarray(taps, np.float32))
    assert np.array_equal(tfir.banded_fir_matrix(key, 49),
                          jfir.banded_fir_matrix(key, 49))
    st = tfir.fir_init_state(49, (2, 3), device="cpu")
    assert st.shape == (2, 3, 48) and st.dtype == torch.complex64
    assert np.array_equal(st.numpy(), np.asarray(jfir.fir_init_state(
        49, (2, 3))))
    rng = np.random.default_rng(2)
    s, x = _c64(rng, (2, 48)), _c64(rng, (2, 100))
    ej, nj = jfir._extend(jnp.asarray(s), jnp.asarray(x))
    et, nt = tfir._extend(_t(s), _t(x))
    assert np.array_equal(et.numpy(), ej) and np.array_equal(nt.numpy(), nj)


@pytest.mark.parametrize("method", ["banded", "direct"])
@pytest.mark.parametrize("n", [1880, 620, 93])
def test_fir_block_matches_jax(method, n):
    """Both summation orders reassociate the f32 sum against XLA's: held
    within 1e-5 of the output's scale, over two chained blocks."""
    rng = np.random.default_rng(n)
    taps = rrc_taps(0.35, 49)
    sj = jfir.fir_init_state(49, (3,))
    st = tfir.fir_init_state(49, (3,), device="cpu")
    for _ in range(2):
        x = _c64(rng, (3, n))
        yj, sj = jfir.fir_block(taps, 2.2, sj, jnp.asarray(x), method=method)
        yt, st = tfir.fir_block(taps, 2.2, st, _t(x), method=method)
        _close(yt.numpy(), yj)
        assert np.array_equal(st.numpy(), np.asarray(sj))
    with pytest.raises(ValueError, match="unknown FIR method"):
        tfir.fir_block(taps, 2.2, st, _t(x), method="fft")


# -------------------------------------------------------- CFO search

def _jax_dft_power(tone, nfft):
    """The spectrum of JAX's ``estimate_cfo(method="dft")``, its lines
    as written there (the function returns only the peak)."""
    wm = jfft._dft_matrix(tone.shape[-1], nfft)
    wr = jnp.asarray(wm.real).astype(jnp.bfloat16)
    wi = jnp.asarray(wm.imag).astype(jnp.bfloat16)
    tr = jnp.asarray(tone.real).astype(jnp.bfloat16)
    ti = jnp.asarray(tone.imag).astype(jnp.bfloat16)
    f32 = jnp.float32
    sr = jnp.matmul(tr, wr, preferred_element_type=f32) \
        - jnp.matmul(ti, wi, preferred_element_type=f32)
    si = jnp.matmul(tr, wi, preferred_element_type=f32) \
        + jnp.matmul(ti, wr, preferred_element_type=f32)
    return np.asarray(sr * sr + si * si)


def _chips(rng, n=64, p=128):
    """Preamble chips at random offsets (-900..900 Hz), phases and noise."""
    k = np.arange(p)
    f = rng.uniform(-900, 900, (n, 1))
    ph = rng.uniform(-np.pi, np.pi, (n, 1))
    pn = PREAMBLE_VALUES.astype(np.float32)
    sig = 0.4 * pn * np.exp(1j * (2 * np.pi * f * k / 2000.0 + ph))
    return (sig + _c64(rng, (n, p), 0.05)).astype(np.complex64), pn


def test_cfo_dft_spectrum_and_peak_bin_as_jax_rounds_them():
    rng = np.random.default_rng(3)
    chips, pn = _chips(rng)
    tone = chips * pn
    pj = _jax_dft_power(tone, 512)
    pt = tfft._tone_power(_t(tone), 512, "dft").numpy()
    assert np.abs(pt - pj).max() <= RTOL * pj.max(axis=-1).min()
    assert np.array_equal(pt.argmax(-1), pj.argmax(-1))
    assert np.array_equal(tfft.dft_matrix(128, 512),
                          jfft._dft_matrix(128, 512))


@pytest.mark.parametrize("method", ["dft", "fft"])
def test_estimate_cfo_matches_jax(method):
    rng = np.random.default_rng(4)
    chips, pn = _chips(rng)
    cj, p0j = jfft.estimate_cfo(jnp.asarray(chips), jnp.asarray(pn), 2000.0,
                                nfft=512, method=method)
    ct, p0t = tfft.estimate_cfo(_t(chips), _t(pn), 2000.0, nfft=512,
                                method=method)
    _close(p0t.numpy(), p0j)
    assert np.abs(ct.numpy() - np.asarray(cj)).max() < 1e-3   # Hz
    # zero chips: a flat spectrum, bin 0 and no interpolation
    z = np.zeros((2, 128), np.complex64)
    cz, _ = tfft.estimate_cfo(_t(z), _t(pn), 2000.0, method=method)
    assert np.array_equal(cz.numpy(), np.asarray(jfft.estimate_cfo(
        jnp.asarray(z), jnp.asarray(pn), 2000.0, method=method)[0]))


def test_wipeoff_rotation_matches_jax():
    cfo = np.array([-35.0, 0.0, 12.5, 900.0], np.float32)
    rj = jfft.wipeoff_rotation(248, jnp.asarray(cfo), 2000.0)
    rt = tfft.wipeoff_rotation(248, _t(cfo), 2000.0)
    _close(rt.numpy(), rj)


# ---------------------------------------------------------- Cholesky

@pytest.mark.parametrize("L", [5, 7])
def test_chol_solve_matches_jax(L):
    rng = np.random.default_rng(L)
    m = _c64(rng, (32, 40, L))
    A = (np.conj(np.swapaxes(m, -1, -2)) @ m).astype(np.complex64)
    A += (0.1 * np.eye(L)).astype(np.complex64)
    b = _c64(rng, (32, L))
    xj = np.asarray(jlin.chol_solve_hermitian(jnp.asarray(A), jnp.asarray(b)))
    xt = tlin.chol_solve_hermitian(_t(A), _t(b)).numpy()
    _close(xt, xj)
    assert np.abs(A @ xt[..., None] - b[..., None]).max() < 1e-3


# --------------------------------------------------------- LS equalizer

def _packets(rng, n=24, win=384, noise=0.15):
    """QPSK packets through a mild 5-tap channel: preamble chips (half
    amplitude) at index 2, data after them, noise."""
    pn = PREAMBLE_VALUES.astype(np.float32)
    d = rng.integers(0, 4, (n, win))
    s = ((1 - 2 * (d >> 1)) + 1j * (1 - 2 * (d & 1))).astype(np.complex64)
    s[:, 2:130] = 0.5 * pn * (1 + 1j)
    h = np.array([0.05, -0.1, 1.0, 0.2, -0.05], np.complex64) \
        * np.exp(1j * 0.3)
    y = np.stack([np.convolve(r, h, mode="same") for r in s])
    return (y + _c64(rng, (n, win), noise)).astype(np.complex64), pn


@pytest.mark.parametrize("center", [True, False])
def test_window_matrix_matches_jax(center):
    rng = np.random.default_rng(6)
    sym = _c64(rng, (3, 384))
    for start, count in ((2, 128), (130, 248), (0, 128), (300, 248)):
        wj = np.asarray(jax.vmap(lambda r: jls.window_matrix(
            r, start, count, 5, center=center))(jnp.asarray(sym)))
        wt = tls.window_matrix(_t(sym), start, count, 5,
                               center=center).numpy()
        assert np.array_equal(wt, wj)
    for reg, off in ((1e-4, 1.0), (1e-3, None)):
        assert np.array_equal(tls._ridge_diag(5, reg, off),
                              jls._ridge_diag(5, reg, off))


def test_ls_train_decode_refit_match_jax():
    rng = np.random.default_rng(7)
    pkt, pn = _packets(rng)
    cj, mj = jax.jit(jax.vmap(lambda r: jls.ls_train(
        r, 2, jnp.asarray(pn), 5, 1e-4, offtap_reg=1.0)))(jnp.asarray(pkt))
    ct, mt = tls.ls_train(_t(pkt), 2, _t(pn), 5, 1e-4, offtap_reg=1.0)
    _close(ct.numpy(), cj)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert mt.dtype == torch.int32 and int(mt.min()) > 120
    for n_fit in (0, 128):
        rj = jax.jit(jax.vmap(lambda r, c: jls.ls_refit(
            r, 130, c, 248, offtap_reg=0.1, n_fit=n_fit)))(jnp.asarray(pkt),
                                                           cj)
        rt = tls.ls_refit(_t(pkt), 130, ct, 248, offtap_reg=0.1,
                          n_fit=n_fit)
        _close(rt.numpy(), rj)
    dj = jax.jit(jax.vmap(lambda r, c: jls.ls_decode(r, 130, c, 248)))(
        jnp.asarray(pkt), cj)
    dt = tls.ls_decode(_t(pkt), 130, ct, 248)
    _close(dt.numpy(), dj)
    bj, hj = jls.slice_qpsk(dj)
    bt, ht = tls.slice_qpsk(_t(np.asarray(dj)))
    assert bt.dtype == torch.uint8
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(ht.numpy(), np.asarray(hj))


@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_phase_refine_matches_jax(iterations):
    """A residual phase and ramp on decoded symbols: decisions equal,
    corrected symbols and the error metric within 1e-5."""
    rng = np.random.default_rng(8 + iterations)
    d = rng.integers(0, 4, (40, 248))
    s = ((1 - 2 * (d >> 1)) + 1j * (1 - 2 * (d & 1))) * (0.5 - 0.5j)
    k = np.arange(248)
    rot = np.exp(1j * (rng.uniform(-0.3, 0.3, (40, 1))
                       + rng.uniform(-2e-3, 2e-3, (40, 1)) * k))
    raw = (s * rot + _c64(rng, (40, 248), 0.2)).astype(np.complex64)
    cj, dj, ej = jls.phase_refine(jnp.asarray(raw), iterations=iterations)
    ct, dt, et = tls.phase_refine(_t(raw), iterations=iterations)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    _close(ct.numpy(), cj)
    _close(et.numpy(), ej)
    _close(tls._refine_err(_t(raw)).numpy(), jls._refine_err(
        jnp.asarray(raw)))


# ---------------------------------------------------------- scrambler

def test_scrambler_matches_jax():
    rng = np.random.default_rng(9)
    for off, count in ((0, 496), (32700, 200), (12345, 1)):
        assert np.array_equal(tscr.dibit_masks(off, count).numpy(),
                              np.asarray(jscr.dibit_masks(off, count)))
    dib = rng.integers(0, 4, (3, 4, 248)).astype(np.uint8)
    for off in (0, 777):
        oj, nj = jscr.scramble_dibits(jnp.asarray(dib), off)
        ot, nt = tscr.scramble_dibits(_t(dib), off)
        assert np.array_equal(ot.numpy(), np.asarray(oj)) and nt == int(nj)
        assert np.array_equal(tscr.scramble_dibits(ot, off)[0].numpy(), dib)
    bits = rng.integers(0, 2, (2, 1000)).astype(np.uint8)
    for off in (0, 65530):
        oj, nj = jscr.scramble_bits(jnp.asarray(bits), off)
        ot, nt = tscr.scramble_bits(_t(bits), off)
        assert np.array_equal(ot.numpy(), np.asarray(oj)) and nt == int(nj)
    for n in (0, 1, 100, 40000):
        assert tscr.reference_lfsr_state(n) == jscr.reference_lfsr_state(n)
