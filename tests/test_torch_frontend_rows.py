"""PyTorch port, the per-row front-end: ``fused_frontend_decim`` vs JAX.

The same int16 rows, each with its own random unit phasor and random
downmixed f32 halo, go through the JAX kernel
(``ops/frontend_pallas.fused_frontend_decim``, interpret mode) and the
port's function (its plain version, the tensors being on the CPU), in
both output layouts and both ``decim_dtype``s.  The JAX kernel contracts
the 49 bf16 products in a matmul-shaped f32 sum, the port in ascending
tap order: f32 planes agree to the reassociation of 49 terms (< 2e-5),
bf16 planes to one bf16 ulp.  The row-major layout is f32 whatever
``decim_dtype`` says.  The new tail and phase are elementwise f32 with
the JAX package's operation order: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.ops import frontend_pallas as jfe
from singlecarrier_tpu_torch.config import ModemConfig as TorchConfig
from singlecarrier_tpu_torch.ops import frontend

N = 8


def _rows(seed):
    rng = np.random.default_rng(seed)
    n, halo = CFG.frame_size, CFG.ntaps - 1
    tx = np.load("tests/golden/reference.npz")["tx_pcm"].astype(np.float64)
    pcm = np.empty((N, n), np.int16)
    for r in range(N):
        s = int(rng.integers(0, len(tx) - n))
        x = tx[s:s + n] + rng.normal(0, 800.0, n)
        pcm[r] = np.clip(x, -32768, 32767).astype(np.int16)
    ph = rng.uniform(0, 2 * np.pi, N)
    return (pcm, np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32),
            (rng.normal(size=(N, halo)) * 0.3).astype(np.float32),
            (rng.normal(size=(N, halo)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("transposed", [True, False],
                         ids=["transposed", "rowmajor"])
@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_fused_frontend_decim_matches_jax_kernel(decim_dtype, transposed):
    cfg = CFG.replace(decim_dtype=decim_dtype)
    tcfg = TorchConfig(**dataclasses.asdict(cfg))
    rows = _rows(seed=31)
    want = jfe.fused_frontend_decim(
        cfg, *(jnp.asarray(a) for a in rows), block_channels=N,
        transposed=transposed, interpret=True)
    got = frontend.fused_frontend_decim(
        tcfg, *(torch.from_numpy(a) for a in rows), block_channels=N,
        transposed=transposed, interpret=True)

    bf16 = decim_dtype == "bf16" and transposed
    shape = ((cfg.cycles, 2, N, cfg.symbols_per_block) if transposed
             else (N, cfg.cycles, 2, cfg.symbols_per_block))
    assert tuple(got[0].shape) == shape == want[0].shape
    assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert want[0].dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    w = np.asarray(want[0].astype(jnp.float32))
    err = np.abs(got[0].float().numpy() - w)
    if bf16:
        _, e = np.frexp(np.maximum(np.abs(w), 1e-30))
        assert np.all(err <= np.ldexp(1.0, e - 8)), err.max()
    else:
        assert err.max() < 2e-5, err.max()
    assert np.abs(w).max() > 0.5             # real signal went through
    # new tail (r, i) and new phase (r, i): exact
    for a, b in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_the_two_layouts_hold_the_same_f32_planes():
    tcfg = TorchConfig(**dataclasses.asdict(CFG))
    rows = [torch.from_numpy(a) for a in _rows(seed=32)]
    t = frontend.fused_frontend_decim(tcfg, *rows, transposed=True)[0]
    r = frontend.fused_frontend_decim(tcfg, *rows, transposed=False)[0]
    assert torch.equal(t, r.permute(1, 2, 0, 3))


def test_rows_with_batch_phases_and_tails_equal_the_one_kernel_front_end():
    """Given the phases p0 * adv^b and the downmixed tails that
    ``prod_rx_batch`` derives, the per-row front-end reproduces the
    one-kernel front-end (``frontend_decim``) bit for bit: same products,
    same roundings."""
    from singlecarrier_tpu_torch.dsp.mixer import downmix_tail
    tcfg = TorchConfig(**dataclasses.asdict(
        CFG.replace(decim_dtype="bf16")))
    B, C = 2, 4
    pcm, p0r, p0i, t0r, t0i = (torch.from_numpy(a) for a in _rows(seed=33))
    pcm, p0r, p0i, t0r, t0i = (pcm.reshape(B, C, -1), p0r[:C], p0i[:C],
                               t0r[:C], t0i[:C])
    n, halo = tcfg.frame_size, tcfg.ntaps - 1
    w_ = -2.0 * np.pi * tcfg.center / tcfg.fs
    advs = np.exp(1j * w_ * n * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag]))
    want = frontend.frontend_decim(tcfg, pcm, p0r, p0i, t0r, t0i, adv)
    ph_r = p0r[None] * adv[0][:, None] - p0i[None] * adv[1][:, None]
    ph_i = p0r[None] * adv[1][:, None] + p0i[None] * adv[0][:, None]
    x_t = pcm[:, :, n - halo:].float() * (1.0 / tcfg.tx_amplitude)
    tl_r, tl_i = downmix_tail(tcfg.center, tcfg.fs, n, halo, x_t,
                              ph_r[..., None], ph_i[..., None])
    got = frontend.fused_frontend_decim(
        tcfg, pcm.reshape(B * C, n), ph_r.reshape(-1), ph_i.reshape(-1),
        torch.cat([t0r[None], tl_r[:-1]]).reshape(B * C, halo),
        torch.cat([t0i[None], tl_i[:-1]]).reshape(B * C, halo),
        transposed=True)[0]
    assert torch.equal(got, want)
