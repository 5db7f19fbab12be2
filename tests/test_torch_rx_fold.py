"""PyTorch port, ``prod_rx_batch`` with ``cfg.mixer_fold`` vs JAX.

The one-kernel path (``fuse_frontend=True``, TPU kernel
``_fused_rx_kernel_folded``) and the two-kernel path
(``fuse_frontend=False``, ``_kernel_decim_folded`` then the hunt+decode
kernel) run the same int16 streams as the JAX package in interpret mode,
at the bench operating point and the library default, with the stream
split across two calls.  Each call of the port starts from the JAX state
before it, carried through ``interop.planes_from_numpy``.  Decisions are
held to the ROADMAP criterion: identical valid, bits on valid rows, lag
and phase on detected rows, |dcfo| < 0.5 Hz, |deq_error| < 2e-3.  The
carried phase and tail agree to 1e-6, the carried decim planes to the
front-end's tolerance (test_torch_frontend_folded.py): one bf16 ulp plus
2e-5, or 2e-5 in f32, and ``HALO_TOL`` on the symbols that reach a
halo which was un-rotated (the two-kernel path only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch.interop import (config_from_dict,
                                             planes_from_numpy)
from singlecarrier_tpu_torch.modem import prod_rx_batch

FOLD = CFG.replace(mixer_fold=True)
BENCH = FOLD.replace(decim_dtype="bf16", hunt_dtype="int8",
                     ls_refit_symbols=128)
C = 4
HALO_TOL = 4e-3         # 3 bf16 flips of a full-scale sample, largest tap


def _awgn_frames(seed=23):
    """3 random-payload scrambled packets per channel, distinct delays,
    AWGN at ~15 dB below the data amplitude."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = CFG.frame_size
    nb = 6
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, 1400))
        x[c, d:d + len(pcm)] = pcm[:nb * n - d]
    x += rng.normal(0, 2000.0, x.shape)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    return x.reshape(C, nb, n).transpose(1, 0, 2).copy(), bits


def _run_both(cfg, frames, fuse_frontend):
    half = frames.shape[0] // 2
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    st_j = jrx.prod_rx_init_planes(cfg, C)
    res = []
    for part in (frames[:half], frames[half:]):
        st_t = planes_from_numpy([np.asarray(a) for a in st_j],
                                 device="cpu")
        st_j, o_j = jrx.prod_rx_batch(
            cfg, st_j, jnp.asarray(part), block_channels=C,
            decode_block_channels=C, fuse_frontend=fuse_frontend,
            interpret=True)
        st_t, o_t = prod_rx_batch(tcfg, st_t, torch.from_numpy(part),
                                  fuse_frontend=fuse_frontend)
        res.append((jax.tree.map(np.asarray, o_j), o_t,
                    [np.asarray(a) for a in st_j], st_t))
    return res


def _assert_parity(o_t, o_j):
    v = o_j.valid
    assert np.array_equal(o_t.valid.numpy(), v)
    assert np.array_equal(o_t.bits.numpy()[v], o_j.bits[v])
    assert np.array_equal(o_t.lag.numpy()[v], o_j.lag[v])
    assert np.array_equal(o_t.timing_phase.numpy()[v], o_j.timing_phase[v])
    assert np.array_equal(o_t.matches.numpy()[v], o_j.matches[v])
    assert np.abs(o_t.cfo_hz.numpy()[v] - o_j.cfo_hz[v]).max() < 0.5
    assert np.abs(o_t.eq_error.numpy()[v] - o_j.eq_error[v]).max() < 2e-3


def _assert_state_close(st_j, st_t):
    for a, b in zip(st_j[:4], st_t[:4]):
        assert np.abs(a - b.numpy()).max() <= 1e-6
    dj = st_j[4].astype(np.float32)
    err = np.abs(dj - st_t[4].float().numpy())
    tol = np.full_like(err, 2e-5)
    if st_t[4].dtype == torch.bfloat16:
        _, e = np.frexp(np.maximum(np.abs(dj), 1e-30))
        tol += np.ldexp(1.0, e - 8)
    tol[..., :10] = np.maximum(tol[..., :10], HALO_TOL)
    assert np.all(err <= tol)


@pytest.mark.parametrize("fuse_frontend", [True, False],
                         ids=["one-kernel", "two-kernel"])
@pytest.mark.parametrize("cfg", [BENCH, FOLD], ids=["bench", "default"])
def test_folded_batch_rx_matches_jax_and_decodes(cfg, fuse_frontend):
    frames, bits = _awgn_frames()
    res = _run_both(cfg, frames, fuse_frontend)
    for o_j, o_t, st_j, st_t in res:
        _assert_parity(o_t, o_j)
        _assert_state_close(st_j, st_t)
    valid = torch.cat([r[1].valid for r in res]).numpy()
    got = torch.cat([r[1].bits for r in res]).numpy()
    sent = bits.reshape(3, CFG.bits_per_frame)
    for c in range(C):
        assert np.array_equal(got[:, c][valid[:, c]], sent)


@pytest.mark.parametrize("cfg", [BENCH, FOLD], ids=["bench", "default"])
def test_folded_paths_agree_with_each_other_and_with_premix(cfg):
    """One-kernel fold, two-kernel fold and premix decide alike on the
    port's side too (their planes differ by bf16 noise)."""
    frames, _ = _awgn_frames(seed=24)
    outs = []
    for c, fuse in ((cfg, True), (cfg, False),
                    (cfg.replace(mixer_fold=False), True)):
        tcfg = config_from_dict(dataclasses.asdict(c))
        st = planes_from_numpy(
            [np.asarray(a) for a in jrx.prod_rx_init_planes(c, C)],
            device="cpu")
        outs.append(prod_rx_batch(tcfg, st, torch.from_numpy(frames),
                                  fuse_frontend=fuse)[1])
    v = outs[0].valid
    assert int(v.sum()) == 3 * C
    for o in outs[1:]:
        assert torch.equal(o.valid, v)
        assert torch.equal(o.bits[v], outs[0].bits[v])
        assert torch.equal(o.lag[v], outs[0].lag[v])
        assert torch.equal(o.timing_phase[v], outs[0].timing_phase[v])
