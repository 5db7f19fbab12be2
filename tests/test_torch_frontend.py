"""PyTorch port, front-end: tables and ``frontend_decim_ref`` vs JAX.

The port's front-end (``singlecarrier_tpu_torch.ops.frontend``) must
produce the decim planes of the JAX front-end kernel
(``fused_frontend_decim(transposed=True)``, run in interpret mode) from
the same int16 input and carried state.  The JAX kernel contracts 49
bf16 products in an MXU-shaped f32 matmul; the port sums them in
ascending tap order, so the f32 planes differ by f32 reassociation of
49 terms (|err| <= 49 * 2^-24 * sum|w u|, below 2e-5 here) and the bf16
planes by at most one bf16 ulp.  The halo for block b > 0 is recomputed
by the port from the previous block's raw tail with the same products.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.dsp import fftops as jfft
from singlecarrier_tpu.dsp import mixer as jmix
from singlecarrier_tpu.ops import frontend_pallas as jfe
from singlecarrier_tpu_torch.config import ModemConfig as TorchConfig
from singlecarrier_tpu_torch.dsp import fftops, mixer
from singlecarrier_tpu_torch.ops import frontend

C, B = 4, 3
TCFG = TorchConfig(**dataclasses.asdict(CFG))


def test_mixer_table_and_downmix_tail_match_jax():
    n, halo = CFG.frame_size, CFG.ntaps - 1
    assert np.array_equal(mixer.mixer_table(-CFG.center, CFG.fs, n),
                          jmix.mixer_table(-CFG.center, CFG.fs, n))
    rng = np.random.default_rng(3)
    x_t = rng.normal(size=(C, halo)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, C)
    pr = np.cos(ph).astype(np.float32)[:, None]
    pi = np.sin(ph).astype(np.float32)[:, None]
    want = jmix.downmix_tail(CFG.center, CFG.fs, n, halo, jnp.asarray(x_t),
                             jnp.asarray(pr), jnp.asarray(pi))
    got = mixer.downmix_tail(CFG.center, CFG.fs, n, halo,
                             torch.from_numpy(x_t), torch.from_numpy(pr),
                             torch.from_numpy(pi))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_dft_matrix_matches_jax():
    assert np.array_equal(fftops.dft_matrix(128, 512),
                          jfft._dft_matrix(128, 512))


def test_decim_taps_are_the_jax_tap_matrix_band():
    halo = CFG.ntaps - 1
    args = (CFG.alpha, CFG.ntaps, CFG.fir_gain, CFG.cycles, 128, 128,
            128 + CFG.cycles * 128)
    t = frontend._decim_tap_matrix_aligned(*args)
    assert np.array_equal(t, jfe._decim_tap_matrix_aligned(*args))
    # every column holds the same 49 taps; the kernel consumes them in
    # the front-end dtype, as the JAX kernel's .astype(bf16) operand
    w = frontend.decim_taps(TCFG)
    lead = 128 - halo
    col = t[lead + 7 * CFG.cycles + 3:lead + 7 * CFG.cycles + 3 + CFG.ntaps,
            3 * 128 + 7]
    want = np.asarray(jnp.asarray(col).astype(jnp.bfloat16).astype(
        jnp.float32))
    assert np.array_equal(w.numpy(), want)


def _inputs(seed):
    """Golden packets + AWGN in B blocks x C channels, and a random
    carried state (unit phasor, downmixed-scale tail)."""
    rng = np.random.default_rng(seed)
    n, halo = CFG.frame_size, CFG.ntaps - 1
    tx = np.load("tests/golden/reference.npz")["tx_pcm"].astype(np.float64)
    pcm = np.empty((B, C, n), np.int16)
    for c in range(C):
        s = int(rng.integers(0, len(tx) - B * n))
        x = tx[s:s + B * n] + rng.normal(0, 800.0, B * n)
        pcm[:, c] = np.clip(x, -32768, 32767).astype(np.int16).reshape(B, n)
    ph = rng.uniform(0, 2 * np.pi, C)
    p0r = np.cos(ph).astype(np.float32)
    p0i = np.sin(ph).astype(np.float32)
    t0r = (rng.normal(size=(C, halo)) * 0.2).astype(np.float32)
    t0i = (rng.normal(size=(C, halo)) * 0.2).astype(np.float32)
    return pcm, p0r, p0i, t0r, t0i


def _jax_decim(cfg, pcm, p0r, p0i, t0r, t0i, advs):
    """The JAX front-end kernel with the per-row phases and halos that
    prod_rx_batch's two-kernel path derives (rx_production.py:807-845)."""
    n, halo = cfg.frame_size, cfg.ntaps - 1
    ar = jnp.asarray(advs.real[:B, None])
    ai = jnp.asarray(advs.imag[:B, None])
    ph_r = jnp.asarray(p0r)[None] * ar - jnp.asarray(p0i)[None] * ai
    ph_i = jnp.asarray(p0r)[None] * ai + jnp.asarray(p0i)[None] * ar
    x_t = jnp.asarray(pcm[:, :, n - halo:]).astype(jnp.float32) * (
        1.0 / cfg.tx_amplitude)
    tl_r, tl_i = jmix.downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                                   ph_r[..., None], ph_i[..., None])
    tr = jnp.concatenate([jnp.asarray(t0r)[None], tl_r[:-1]], 0)
    ti = jnp.concatenate([jnp.asarray(t0i)[None], tl_i[:-1]], 0)
    N = B * C
    dec = jfe.fused_frontend_decim(
        cfg, jnp.asarray(pcm).reshape(N, n), ph_r.reshape(N),
        ph_i.reshape(N), tr.reshape(N, halo), ti.reshape(N, halo),
        transposed=True, interpret=True)[0]
    return np.asarray(dec.astype(jnp.float32))


@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_frontend_decim_ref_matches_jax_kernel(decim_dtype):
    cfg = CFG.replace(decim_dtype=decim_dtype)
    pcm, p0r, p0i, t0r, t0i = _inputs(seed=11)
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * cfg.frame_size * np.arange(B + 1)).astype(
        np.complex64)
    want = _jax_decim(cfg, pcm, p0r, p0i, t0r, t0i, advs)
    adv = torch.from_numpy(np.stack([advs.real[:B], advs.imag[:B]]))
    got = frontend.frontend_decim(
        TCFG.replace(decim_dtype=decim_dtype), torch.from_numpy(pcm),
        torch.from_numpy(p0r), torch.from_numpy(p0i), torch.from_numpy(t0r),
        torch.from_numpy(t0i), adv)
    assert got.shape == (cfg.cycles, 2, B * C, cfg.symbols_per_block)
    assert got.dtype == (torch.bfloat16 if decim_dtype == "bf16"
                         else torch.float32)
    err = np.abs(got.float().numpy() - want)
    if decim_dtype == "f32":
        assert err.max() < 2e-5, err.max()
    else:
        _, e = np.frexp(np.maximum(np.abs(want), 1e-30))
        assert np.all(err <= np.ldexp(1.0, e - 8)), err.max()
    assert np.abs(want).max() > 0.5          # real signal went through
