"""PyTorch port, hunt + extract + decode vs the JAX kernel.

The same decim planes -- made by the JAX front-end kernel from a real
``tx_stream`` with AWGN -- go through the port's ``hunt_ref`` +
``extract_decode_ref`` and through JAX ``fused_hunt_decode_decim`` in
interpret mode, at the bench operating point and the library default.
Held to the decision-level criterion of ``tools/tpu_parity.py``:
identical valid flags, identical bits on valid rows, identical lag and
phase on detected rows, |dcfo| < 0.5 Hz, |deq_error| < 2e-3, and the
hunt peak to rtol 1e-5 on detected rows (the correlation is exact in
int8; f32 sums differ only in order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops.decode_pallas import (
    _cossin_small, _gram_sliding, _slice_hard, _solve_chol,
    fused_hunt_decode_decim)
from singlecarrier_tpu.ops.frontend_pallas import fused_frontend_decim
from singlecarrier_tpu_torch.interop import (config_from_dict,
                                             planes_from_numpy)
from singlecarrier_tpu_torch.ops import decode

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
C = 4
CONFIGS = {"bench": BENCH, "default": CFG}


def _decim_planes(cfg, seed):
    """(dprev0, dcur) numpy planes of a noisy 3-packet stream, C channels
    with distinct delays: block 0 is the carried state, blocks 1.. cur."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = cfg.frame_size
    nb = -(-(len(pcm) + 3 * n) // n)
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, 2 * n))
        x[c, d:d + len(pcm)] = pcm
    x += rng.normal(0, 1500.0, x.shape)
    frames = np.clip(x, -32768, 32767).astype(np.int16).reshape(C, nb, n)
    N = nb * C
    f = jnp.asarray(frames.transpose(1, 0, 2).reshape(N, n))
    ph = rng.uniform(0, 2 * np.pi, N)
    dec = fused_frontend_decim(
        cfg, f, jnp.asarray(np.cos(ph), jnp.float32),
        jnp.asarray(np.sin(ph), jnp.float32),
        jnp.zeros((N, cfg.ntaps - 1)), jnp.zeros((N, cfg.ntaps - 1)),
        transposed=True, interpret=True)[0]
    return np.asarray(dec[:, :, :C]), np.asarray(dec[:, :, C:])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hunt_and_decode_match_jax_kernel(name):
    cfg = CONFIGS[name]
    dprev0, dcur = _decim_planes(cfg, seed=5)
    want = fused_hunt_decode_decim(cfg, jnp.asarray(dprev0),
                                   jnp.asarray(dcur), channels=C,
                                   block_channels=C, interpret=True)
    want = jax.tree.map(np.asarray, want)

    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tp, tc = planes_from_numpy((dprev0, dcur), device="cpu")
    lag, ph, peak = decode.hunt(tcfg, tc, tp)
    out = decode.extract_decode(tcfg, tc, tp, lag, ph, peak).numpy()
    D = cfg.frame_symbols
    got_valid = (out[:, D + 3] > 0.5) & (out[:, D] > cfg.match_threshold)
    want_valid = want["gated"] & (want["matches"] > cfg.match_threshold)

    assert want_valid.sum() >= 6          # the packets were found
    assert np.array_equal(got_valid, want_valid)
    v = want_valid
    assert np.array_equal(out[v, :D], want["dibits"][v])
    assert np.array_equal(lag.numpy()[v], want["lag"][v])
    assert np.array_equal(ph.numpy()[v], want["phase_idx"][v])
    assert np.array_equal(out[v, D + 5], want["lag"][v].astype(np.float32))
    assert np.abs(out[v, D + 2] - want["cfo_hz"][v]).max() < 0.5
    assert np.abs(out[v, D + 1] - want["eq_error"][v]).max() < 2e-3
    assert np.allclose(peak.numpy()[v], want["peak"][v], rtol=1e-5)
    assert np.allclose(out[v, D + 4], want["energy"][v], rtol=1e-5)


def test_solve_chol_and_sliding_gram_match_jax():
    """The unrolled Cholesky solve of the sliding-Gram normal equations
    on random windows (rows are independent problems)."""
    rng = np.random.default_rng(2)
    L, count = 5, 40
    pr = rng.normal(size=(6, count + L - 1)).astype(np.float32)
    pi = rng.normal(size=(6, count + L - 1)).astype(np.float32)
    A_j = _gram_sliding(jnp.asarray(pr), jnp.asarray(pi), L, count)
    A_t = decode._gram_sliding(torch.from_numpy(pr), torch.from_numpy(pi),
                               L, count)
    for dj, dt in zip(A_j, A_t):
        assert dj.keys() == dt.keys()
        for k in dj:
            assert np.allclose(np.asarray(dj[k]), dt[k].numpy(),
                               rtol=1e-5, atol=1e-4)
    b_r = [rng.normal(size=(6, 1)).astype(np.float32) for _ in range(L)]
    b_i = [rng.normal(size=(6, 1)).astype(np.float32) for _ in range(L)]
    for A_r in (A_j[0], A_t[0]):
        A_r[(2, 2)] = A_r[(2, 2)] + 1.0
    x_j = _solve_chol(*A_j, [jnp.asarray(b) for b in b_r],
                      [jnp.asarray(b) for b in b_i], L)
    x_t = decode._solve_chol(*A_t, [torch.from_numpy(b) for b in b_r],
                             [torch.from_numpy(b) for b in b_i], L)
    for pj, pt in zip(x_j, x_t):
        for a, b in zip(pj, pt):
            assert np.allclose(np.asarray(a), b.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_slicer_and_taylor_cossin_match_jax_exactly():
    x = np.linspace(-0.8, 0.8, 257, dtype=np.float32)
    for a, b in zip(_cossin_small(jnp.asarray(x)),
                    decode._cossin_small(torch.from_numpy(x))):
        assert np.array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(4)
    ar = rng.normal(size=(3, 64)).astype(np.float32)
    ai = rng.normal(size=(3, 64)).astype(np.float32)
    for a, b in zip(_slice_hard(jnp.asarray(ar), jnp.asarray(ai)),
                    decode._slice_hard(torch.from_numpy(ar),
                                       torch.from_numpy(ai))):
        assert np.array_equal(np.asarray(a), b.numpy())
