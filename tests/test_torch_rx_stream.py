"""PyTorch port, the streaming entry points against JAX and the batch path.

``prod_rx_stream_pallas`` (plane-typed body: kernels #3 and #5 per
block, a Python loop for ``lax.scan``) and
``prod_rx_stream_superstep(superstep=2)`` (a loop of ``prod_rx_batch``)
run the same int16 streams as the JAX functions of the same names
(Pallas kernels in interpret mode, C = 4), at the bench operating point
and the library default, and as the port's own batch path.

Tolerances: decisions by ``tools/tpu_parity.py``'s criterion (identical
valid, bits on valid rows, lag and phase on detected rows, |dcfo| <
0.5 Hz, |deq_error| < 2e-3).  The final state: phase and tail to 1e-6
(the per-block phase advance renormalizes, the batch path's is closed
form); decim planes to one bf16 ulp at ``decim_dtype="bf16"``, else to
the f32 reassociation of the 49-term filter sum (< 2e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (ProdRxState, make_prod_rx_fn,
                                           prod_rx_batch, prod_rx_init,
                                           prod_rx_init_planes,
                                           prod_rx_stream_pallas,
                                           prod_rx_stream_superstep)

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
CONFIGS = {"bench": BENCH, "default": CFG}
C = 4
GOLDEN_DELAYS = (0, 3, 377, 1879)
NB = 6                      # blocks: 3 of the golden stream's packets


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _frames(golden, noise=0.0, seed=3):
    tx = golden["tx_pcm"].astype(np.float64)
    n = CFG.frame_size
    x = np.zeros((C, NB * n))
    for c, d in enumerate(GOLDEN_DELAYS):
        x[c, d:] = tx[:NB * n - d]
    if noise:
        x += np.random.default_rng(seed).normal(0, noise, x.shape)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    return x.reshape(C, NB, n).transpose(1, 0, 2).copy()


def _assert_parity(o_t, o_j, min_valid=8):
    o_j = jax.tree.map(np.asarray, o_j)
    v = o_j.valid
    assert v.sum() >= min_valid
    assert np.array_equal(o_t.valid.numpy(), v)
    assert np.array_equal(o_t.bits.numpy()[v], o_j.bits[v])
    assert np.array_equal(o_t.lag.numpy()[v], o_j.lag[v])
    assert np.array_equal(o_t.timing_phase.numpy()[v], o_j.timing_phase[v])
    assert np.array_equal(o_t.matches.numpy()[v], o_j.matches[v])
    assert np.abs(o_t.cfo_hz.numpy()[v] - o_j.cfo_hz[v]).max() < 0.5
    assert np.abs(o_t.eq_error.numpy()[v] - o_j.eq_error[v]).max() < 2e-3
    for a, b in zip(o_t, o_j):
        assert tuple(a.shape) == b.shape


def _assert_planes_close(pj, pt, bf16):
    err = np.abs(pj - pt)
    if bf16:
        _, e = np.frexp(np.maximum(np.abs(pj), 1e-30))
        assert np.all(err <= np.ldexp(1.0, e - 8))
    else:
        assert err.max() < 2e-5


def _assert_state_close(st_j, st_t, bf16):
    st_j = [np.asarray(a) for a in st_j]
    assert isinstance(st_t, ProdRxState)
    for a, b in zip(st_j[:2], st_t[:2]):
        assert np.abs(a - b.numpy()).max() <= 1e-6
    dj, dt = st_j[2], st_t[2].numpy()
    _assert_planes_close(dj.real, dt.real, bf16)
    _assert_planes_close(dj.imag, dt.imag, bf16)


@pytest.mark.parametrize("noise", [0.0, 2000.0], ids=["clean", "awgn"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_matches_jax_stream_and_the_batch_path(name, noise, golden):
    cfg, tcfg = CONFIGS[name], _tcfg(CONFIGS[name])
    frames = _frames(golden, noise)
    st_j, o_j = jrx.prod_rx_stream_pallas(
        cfg, jrx.prod_rx_init(cfg, (C,)), jnp.asarray(frames),
        descramble=False, block_channels=C, decode_block_channels=C,
        interpret=True)
    fn = make_prod_rx_fn(tcfg, descramble=False, pallas=True)
    st_t, o_t = fn(prod_rx_init(tcfg, (C,), "cpu"), torch.from_numpy(frames))
    _assert_parity(o_t, o_j)
    _assert_state_close(st_j, st_t, cfg.decim_dtype == "bf16")

    # the stream split in two calls carries its state exactly
    st_a, o_a = prod_rx_stream_pallas(
        tcfg, prod_rx_init(tcfg, (C,), "cpu"), torch.from_numpy(frames[:2]),
        descramble=False)
    st_b, o_b = prod_rx_stream_pallas(tcfg, st_a,
                                      torch.from_numpy(frames[2:]),
                                      descramble=False)
    for a, b, c in zip(o_a, o_b, o_t):
        assert torch.equal(torch.cat([a, b]), c)
    for a, b in zip(st_b, st_t):
        assert torch.equal(a, b)

    # the port's batch path on the same frames: the same decisions
    _, o_b = prod_rx_batch(tcfg, prod_rx_init(tcfg, (C,), "cpu"),
                           torch.from_numpy(frames), descramble=False)
    v = o_t.valid
    assert torch.equal(o_b.valid, v)
    for a, b in ((o_b.bits, o_t.bits), (o_b.lag, o_t.lag),
                 (o_b.timing_phase, o_t.timing_phase)):
        assert torch.equal(a[v], b[v])
    assert float((o_b.cfo_hz[v] - o_t.cfo_hz[v]).abs().max()) < 0.5
    assert float((o_b.eq_error[v] - o_t.eq_error[v]).abs().max()) < 2e-3


@pytest.mark.parametrize("fuse_frontend", [False, True],
                         ids=["two-kernel", "one-kernel"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_superstep_matches_jax_superstep_and_one_batch_call(
        name, fuse_frontend, golden):
    cfg, tcfg = CONFIGS[name], _tcfg(CONFIGS[name])
    frames = _frames(golden, 2000.0, seed=4)
    st_j, o_j = jrx.prod_rx_stream_superstep(
        cfg, jrx.prod_rx_init_planes(cfg, C), jnp.asarray(frames),
        superstep=2, descramble=False, block_channels=C,
        decode_block_channels=C, fuse_frontend=fuse_frontend,
        interpret=True)
    st_t, o_t = prod_rx_stream_superstep(
        tcfg, prod_rx_init_planes(tcfg, C, "cpu"), torch.from_numpy(frames),
        superstep=2, descramble=False, block_channels=C,
        decode_block_channels=C, fuse_frontend=fuse_frontend,
        interpret=True)
    _assert_parity(o_t, o_j)
    assert isinstance(st_t, tuple) and len(st_t) == 5
    for a, b in zip(st_j[:4], st_t[:4]):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    assert st_t[4].dtype == (torch.bfloat16 if cfg.decim_dtype == "bf16"
                             else torch.float32)
    _assert_planes_close(np.asarray(st_j[4].astype(jnp.float32)),
                         st_t[4].float().numpy(),
                         cfg.decim_dtype == "bf16")

    # a ProdRxState in gives a ProdRxState out, with the same decisions
    st_c, o_c = prod_rx_stream_superstep(
        tcfg, prod_rx_init(tcfg, (C,), "cpu"), torch.from_numpy(frames),
        superstep=2, descramble=False, fuse_frontend=fuse_frontend)
    assert isinstance(st_c, ProdRxState)
    for a, b in zip(o_c, o_t):
        assert torch.equal(a, b)

    # one batch call over all blocks: the splice between groups is the
    # same closed-form carry, so decisions are equal (the phase of later
    # groups is renormalized once per group: f32 values may differ)
    _, o_b = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                           torch.from_numpy(frames), descramble=False,
                           fuse_frontend=fuse_frontend)
    v = o_t.valid
    assert torch.equal(o_b.valid, v)
    assert torch.equal(o_b.bits[v], o_t.bits[v])
    assert torch.equal(o_b.lag[v], o_t.lag[v])


def test_superstep_needs_whole_groups():
    tcfg = _tcfg(CFG)
    pcm = torch.zeros((3, C, CFG.frame_size), dtype=torch.int16)
    with pytest.raises(ValueError, match="multiple"):
        prod_rx_stream_superstep(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                                 pcm, superstep=2)
    with pytest.raises(TypeError, match="ProdRxState"):
        prod_rx_stream_pallas(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                              pcm)
