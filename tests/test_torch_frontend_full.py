"""PyTorch port, the full-rate front-end: ``fused_frontend`` vs JAX.

The same int16 rows go through the JAX kernel
(``ops/frontend_pallas.fused_frontend``, interpret mode) and the port's
function (its plain version, the tensors being on the CPU), two blocks
chained through the carried tail and phase as in the JAX package's own
continuity test (tests/test_pallas_frontend.py).  Nothing is rounded to
bf16 and both sum the 49 taps in ascending order, so the outputs agree
to a few f32 ulps: measured 3e-7 at |y| < 1.5 (XLA on the CPU fuses
multiply-adds where PyTorch rounds each product; with the tap sum's
fusion emulated in float64 the two are 1.2e-7 apart); held to 1e-6.
The new tail and phase are exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.ops import frontend_pallas as jfe
from singlecarrier_tpu_torch.interop import config_from_dict
from singlecarrier_tpu_torch.ops import frontend

C = 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n, halo = CFG.frame_size, CFG.ntaps - 1
    pcm = rng.integers(-16384, 16384, (C, 2 * n)).astype(np.int16)
    th = rng.uniform(0, 2 * np.pi, C)
    return pcm, [np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
                 (rng.normal(size=(C, halo)) * 0.3).astype(np.float32),
                 (rng.normal(size=(C, halo)) * 0.3).astype(np.float32)]


# frontend_dtype and decim_dtype play no part in this kernel
@pytest.mark.parametrize("cfg", [CFG, CFG.replace(decim_dtype="bf16")],
                         ids=["default", "bf16-decim"])
def test_fused_frontend_matches_jax_over_two_chained_blocks(cfg):
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    pcm, st_j = _inputs(seed=1)
    st_t = [torch.from_numpy(a.copy()) for a in st_j]
    n = cfg.frame_size
    for blk in (pcm[:, :n], pcm[:, n:]):
        want = jfe.fused_frontend(cfg, jnp.asarray(blk),
                                  *(jnp.asarray(a) for a in st_j),
                                  block_channels=C, interpret=True)
        got = frontend.fused_frontend(tcfg, torch.from_numpy(blk.copy()),
                                      *st_t, block_channels=C, interpret=True)
        assert len(got) == len(want) == 6
        for w, g in zip(want[:2], got[:2]):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and tuple(g.shape) == (C, n)
            assert np.abs(g.numpy() - w).max() < 1e-6
            assert np.abs(w).max() > 0.5         # real signal went through
        for w, g in zip(want[2:], got[2:]):
            assert np.array_equal(np.asarray(w), g.numpy())
        # carry (phase_r, phase_i, tail_r, tail_i), each side its own
        st_j = [np.asarray(want[i]) for i in (4, 5, 2, 3)]
        st_t = [got[i].contiguous() for i in (4, 5, 2, 3)]


def test_fused_frontend_is_the_unrounded_filter_of_the_decimating_one():
    """Phase c, symbol s of the decimating front-end is sample 5s + c of
    the full-rate output up to the bf16 rounding of its operands."""
    tcfg = config_from_dict(dataclasses.asdict(CFG))
    pcm, st = _inputs(seed=2)
    args = (torch.from_numpy(pcm[:, :CFG.frame_size].copy()),
            *(torch.from_numpy(a) for a in st))
    fr, fi = frontend.fused_frontend(tcfg, *args)[:2]
    dec = frontend.fused_frontend_decim(tcfg, *args)[0]   # [C, cyc, 2, n_sym]
    full = torch.stack([fr, fi], 1).reshape(
        C, 2, CFG.symbols_per_block, CFG.cycles).permute(0, 3, 1, 2)
    assert float((full - dec).abs().max()) < 2e-2


def test_fused_frontend_ref_is_what_the_cpu_runs():
    tcfg = config_from_dict(dataclasses.asdict(CFG))
    pcm, st = _inputs(seed=3)
    args = (torch.from_numpy(pcm[:, :CFG.frame_size].copy()),
            *(torch.from_numpy(a) for a in st))
    for a, b in zip(frontend.fused_frontend(tcfg, *args),
                    frontend.fused_frontend_ref(tcfg, *args)):
        assert torch.equal(a, b)
    assert tuple(frontend.frontend_full(tcfg, *args).shape) == (
        C, 2, CFG.frame_size)
