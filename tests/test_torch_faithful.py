"""PyTorch port: the faithful path's building blocks against the JAX
package's and the C reference's, on the CPU.

* The square-root Kalman update and the four equalizer steps against
  JAX on numpy-seeded windows, chained over a few steps, batched over
  channels: every leaf within 1e-5 of its scale, the dibits equal, u
  strictly upper.
* The Kalman/equalizer trajectory against the C fixture ``eq_*``
  (``tests/golden/reference.npz``) with ``tests/test_kalman_eq.py``'s
  tolerances (rtol 3e-4, atol 1e-4; the C's open-loop recursion diverges)
  and the descrambled dibits equal.
* The blocked RLS blocks, ``decimate_at``, ``preamble_correlate`` and
  ``window_energy`` against JAX: within 1e-5 of scale, integers equal.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu import adaptive as jad
from singlecarrier_tpu.adaptive import blocked_rls as jbl
from singlecarrier_tpu.constants import PREAMBLE_TABLE, PREAMBLE_VALUES
from singlecarrier_tpu.constants import scramble_dibit_mask
from singlecarrier_tpu_torch import adaptive as tad
from singlecarrier_tpu_torch.adaptive import blocked_rls as tbl
from singlecarrier_tpu_torch.dsp import correlate as tcorr
from singlecarrier_tpu_torch.dsp import decimate as tdec

# the modules, not the functions of the same names dsp/__init__ exports
jcorr = importlib.import_module("singlecarrier_tpu.dsp.correlate")
jdec = importlib.import_module("singlecarrier_tpu.dsp.decimate")

E, Q, L, C = 0.1, 0.08, 5, 3
JAX_TRAIN = jax.jit(lambda s, x, r: jad.train_step(s, x, r, E, Q))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq_close(st_t, st_j):
    _close(st_t.kalman.u, st_j.kalman.u)
    _close(st_t.kalman.d, st_j.kalman.d)
    _close(st_t.coeff, st_j.coeff)


# ------------------------------------------------- (a) steps against JAX

def test_kalman_update_matches_jax_over_chained_steps():
    rng = np.random.default_rng(3)
    upd = jax.jit(functools.partial(jad.kalman_update, E=E, q=Q))
    sj = jad.kalman_init(L, (C,))
    st = tad.kalman_init(L, (C,), device="cpu")
    for _ in range(6):
        x = _cplx(rng, C, L)
        sj, gj, yj = upd(sj, jnp.asarray(x))
        st, gt, yt = tad.kalman_update(st, _t(x), E, Q)
        for a, b in ((st.u, sj.u), (st.d, sj.d), (gt, gj), (yt, yj)):
            _close(a, b)
        u = st.u.numpy()
        assert np.all(u[:, np.tril_indices(L)[0], np.tril_indices(L)[1]]
                      == 0)
    assert st.u.dtype == torch.complex64 and st.d.dtype == torch.float32


@pytest.mark.parametrize("step", ["train", "data", "coherent", "nlms"])
def test_equalizer_steps_match_jax_over_chained_steps(step):
    """Six steps of one kind from kalman_reset, each carrying the state
    of the last; the training reference a real chip per channel."""
    rng = np.random.default_rng({"train": 4, "data": 5, "coherent": 6,
                                 "nlms": 7}[step])
    refs = np.where(rng.random((6, C)) < 0.5, -1.0, 1.0).astype(np.float32)
    jfn = JAX_TRAIN if step == "train" else jax.jit({
        "data": lambda s, x, r: jad.data_step(s, x, E, Q),
        "coherent": lambda s, x, r: jad.data_step_coherent(s, x, E, Q),
        "nlms": lambda s, x, r: jad.data_step_nlms(s, x),
    }[step])
    tfn = {
        "train": lambda s, x, r: tad.train_step(s, x, r, E, Q),
        "data": lambda s, x, r: tad.data_step(s, x, E, Q),
        "coherent": lambda s, x, r: tad.data_step_coherent(s, x, E, Q),
        "nlms": lambda s, x, r: tad.data_step_nlms(s, x),
    }[step]
    sj = jad.eq_init(L, (C,))
    st = tad.eq_init(L, (C,), device="cpu")
    # a trained start, so the data steps slice something
    for k in range(3):
        x = _cplx(rng, C, L)
        sj, _ = JAX_TRAIN(sj, jnp.asarray(x), jnp.asarray(refs[k]))
        st, _ = tad.train_step(st, _t(x), _t(refs[k]), E, Q)
    for k in range(6):
        x = _cplx(rng, C, L)
        oj = jfn(sj, jnp.asarray(x), jnp.asarray(refs[k]))
        ot = tfn(st, _t(x), _t(refs[k]))
        sj, st = oj[0], ot[0]
        _eq_close(st, sj)
        _close(ot[-1], oj[-1])                     # the error
        if step != "train":
            assert ot[1].dtype == torch.uint8
            assert np.array_equal(ot[1].numpy(), np.asarray(oj[1]))


# ---------------------------------------------- (b) the C trajectory

def test_trajectory_matches_the_c_reference(golden):
    """train_eq x128 on the preamble chips, then data_eq x31, from
    kalman_reset (the C harness's open-loop input ``eq_in``)."""
    syms = torch.from_numpy(golden["eq_in"])
    eq = tad.eq_init(L, device="cpu")
    train_errs = []
    for t in range(128):
        eq, err = tad.train_step(eq, syms[t:t + L],
                                 float(PREAMBLE_VALUES[t]), E, Q)
        train_errs.append(float(err))
    coeff_train = eq.coeff.numpy().copy()
    dibits, data_errs = [], []
    for t in range(128, 128 + 31):
        eq, dibit, err = tad.data_step(eq, syms[t:t + L], E, Q)
        dibits.append(int(dibit))
        data_errs.append(float(err))
    tol = dict(rtol=3e-4, atol=1e-4)
    assert np.allclose(train_errs, golden["eq_train_err"], **tol)
    assert np.allclose(coeff_train, golden["eq_coeff_after_train"], **tol)
    # data_eq dumps the dibit AFTER its descramble (equalizer.c:87)
    assert np.array_equal(np.array(dibits, np.uint8) ^ scramble_dibit_mask()
                          [:31], golden["eq_data_dibits"])
    assert np.allclose(data_errs, golden["eq_data_err"], **tol)
    assert np.allclose(eq.coeff.numpy(), golden["eq_coeff_after_data"],
                       **tol)


def test_kalman_reset_and_the_training_on_a_clean_channel():
    """kalman_init is u = 0, d = 1; on a noiseless identity channel the
    training slices the preamble well before 128 chips (qpsk.c:196)."""
    st = tad.kalman_init(L, (2,), device="cpu")
    assert np.all(st.u.numpy() == 0) and np.all(st.d.numpy() == 1.0)
    pre = PREAMBLE_VALUES.astype(np.float32)
    syms = torch.from_numpy(np.concatenate([pre + 1j * pre, (pre + 1j * pre)
                                            [:L]]).astype(np.complex64))
    eq, matches = tad.eq_init(L, device="cpu"), 0
    for t in range(128):
        eq, err = tad.train_step(eq, syms[t:t + L], float(pre[t]), E, Q)
        matches += int(float(err) * pre[t] > 0)
    assert matches > 98


# --------------------------------------- (c) blocks and DSP against JAX

@pytest.mark.parametrize("count_post", [True, False])
def test_blocked_rls_blocks_match_jax(count_post):
    """A training block then a data block with a ragged tail, from
    blocked_eq_init, batched over channels."""
    rng = np.random.default_rng(8 + count_post)
    B, lam_B = 32, float((1.0 / (1.0 + Q)) ** 32)
    Z, W = _cplx(rng, C, B, L), _cplx(rng, C, B, L)
    refs = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    tmask = (np.arange(B) < 27).astype(np.float32)
    sj = jbl.blocked_eq_init(L, E, (C,))
    st = tbl.blocked_eq_init(L, E, (C,), device="cpu")
    sj, mj = jax.jit(lambda s, z: jbl.train_block(
        s, z, jnp.asarray(refs), jnp.asarray(tmask), lam_B, E,
        count_post=count_post))(sj, jnp.asarray(Z))
    st, mt = tbl.train_block(st, _t(Z), _t(refs), _t(tmask), lam_B, E,
                             count_post=count_post)
    assert mt.dtype == torch.int32
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    _close(st.r, sj.r)
    _close(st.coeff, sj.coeff)
    sj, dj, ej = jax.jit(lambda s, w: jbl.data_block(
        s, w, jnp.asarray(tmask), lam_B, E))(sj, jnp.asarray(W))
    st, dt, et = tbl.data_block(st, _t(W), _t(tmask), lam_B, E)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    _close(et, ej)
    _close(st.r, sj.r)
    _close(st.coeff, sj.coeff)


def test_decimate_correlate_and_window_energy_match_jax():
    rng = np.random.default_rng(10)
    n_sym, cyc = 376, 5
    x = _cplx(rng, C, 2 * 1880)
    offs = np.array([3, 255, 127], np.int32)
    got = tdec.decimate_at(_t(x), _t(offs), cyc, n_sym)
    assert np.array_equal(got.numpy(), np.asarray(jdec.decimate_at(
        jnp.asarray(x), jnp.asarray(offs), cyc, n_sym)))
    # a negative offset counts from the end; past the end reads NaN
    edge = np.array([-7, 3000, 0], np.int32)
    got = tdec.decimate_at(_t(x), _t(edge), cyc, n_sym).numpy()
    want = np.asarray(jdec.decimate_at(jnp.asarray(x), jnp.asarray(edge),
                                       cyc, n_sym))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.array_equal(tdec.decimate(_t(x), cyc, 2).numpy(),
                          np.asarray(jdec.decimate(jnp.asarray(x), cyc, 2)))

    syms = _cplx(rng, C, 2 * n_sym)
    corr_t = tcorr.preamble_correlate(_t(syms), PREAMBLE_TABLE, 128)
    corr_j = jcorr.preamble_correlate(jnp.asarray(syms), PREAMBLE_TABLE, 128)
    _close(corr_t, corr_j)
    assert np.array_equal(corr_t.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(corr_j, axis=-1)))
    _close(tcorr.window_energy(_t(syms), 128, 128),
           jcorr.window_energy(jnp.asarray(syms), 128, 128))
    assert np.array_equal(
        tcorr.preamble_corr_matrix(tuple(PREAMBLE_TABLE.tolist()), 128),
        jcorr.preamble_corr_matrix(tuple(PREAMBLE_TABLE.tolist()), 128))
