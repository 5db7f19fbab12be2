"""PyTorch port: the shape/dtype assertion layer and the step-output
finiteness checks (``singlecarrier_tpu_torch.runtime.validate``), the
five cases of ``tests/test_validate.py`` on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as JCFG
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import prod_rx_frame, prod_rx_init
from singlecarrier_tpu_torch.runtime import (StreamDemodulator,
                                             assert_pcm_block,
                                             assert_rx_state, checkify_step)

CFG = interop.config_from_dict(dataclasses.asdict(JCFG))


def test_assert_rx_state_accepts_valid():
    assert_rx_state(CFG, prod_rx_init(CFG, (4,), device="cpu"), 4)
    assert_rx_state(CFG, prod_rx_init(CFG, device="cpu"))
    # numpy leaves pass the same checks
    st = prod_rx_init(CFG, (4,), device="cpu")
    assert_rx_state(CFG, type(st)(*(x.numpy() for x in st)), 4)


def test_assert_rx_state_rejects_wrong_shape():
    st = prod_rx_init(CFG, (4,), device="cpu")
    bad = st._replace(fir_tail=st.fir_tail[:, :10])
    with pytest.raises(AssertionError, match="fir_tail"):
        assert_rx_state(CFG, bad, 4)
    with pytest.raises(AssertionError, match="phase.*complex64"):
        assert_rx_state(CFG, st._replace(phase=st.phase.real), 4)


def test_assert_pcm_block_rejects_float():
    for pcm in (np.zeros((2, CFG.frame_size), np.float32),
                torch.zeros((2, CFG.frame_size))):
        with pytest.raises(AssertionError, match="int16"):
            assert_pcm_block(CFG, pcm, 2)
    assert_pcm_block(CFG, torch.zeros((2, CFG.frame_size),
                                      dtype=torch.int16), 2)
    with pytest.raises(AssertionError, match="shape"):
        assert_pcm_block(CFG, np.zeros((3, CFG.frame_size), np.int16), 2)


def test_stream_demodulator_validate_flag():
    demod = StreamDemodulator(CFG, 2, metrics=False, validate=True,
                              device="cpu")
    out = demod.push(np.zeros((2, CFG.frame_size), np.int16))
    assert not bool(out.valid.any())
    with pytest.raises(AssertionError):
        demod.push(np.zeros((2, CFG.frame_size), np.float32))


def test_checkify_step_flags_internal_nan():
    """A NaN smuggled into the carried state must surface as a checked
    error naming the leaf, not silently propagate."""
    step = checkify_step(
        lambda st, pcm: prod_rx_frame(CFG, st, pcm, descramble=False))
    st = prod_rx_init(CFG, device="cpu")
    pcm = torch.zeros((CFG.frame_size,), dtype=torch.int16)
    step(st, pcm)  # clean state passes

    bad = st._replace(phase=torch.tensor(complex(float("nan"), 0.0),
                                         dtype=torch.complex64))
    with pytest.raises(FloatingPointError,
                       match=r"non-finite.*\[0\]\.phase"):
        step(bad, pcm)


def test_hunt_treats_nan_as_the_maximum_as_jax_does():
    """A NaN in the hunt's metric (a poisoned state) picks the first NaN
    in (phase, lag) order, as ``jnp.argmax`` does, instead of an index
    past the lags."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.modem import rx_production as jrx
    from singlecarrier_tpu_torch.modem import rx_production as trx

    rng = np.random.default_rng(5)
    shape = (5, CFG.cycles, 2 * CFG.symbols_per_block)
    w = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    w[0] = np.nan                       # every sample
    w[1, 2, 300] = np.nan               # one sample of one phase
    w[2, 0, 10] = complex(0.0, np.nan)
    w[3, :, 500:] = np.inf
    lag_j, ph_j, peak_j = (np.asarray(x) for x in jax.jit(
        jrx._hunt, static_argnums=0)(JCFG, jnp.asarray(w))[:3])
    lag_t, ph_t, peak_t = (x.numpy() for x in
                           trx._hunt(CFG, torch.from_numpy(w))[:3])
    assert np.array_equal(lag_t, lag_j) and np.array_equal(ph_t, ph_j)
    assert np.array_equal(np.isnan(peak_t), np.isnan(peak_j))
    ok = ~np.isnan(peak_j)
    np.testing.assert_allclose(peak_t[ok], peak_j[ok], rtol=1e-5)
