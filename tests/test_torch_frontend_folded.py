"""PyTorch port, the mixer-folded front-ends vs JAX.

``fused_frontend_decim(mixer_fold=True)`` (TPU kernel
``_kernel_decim_folded``) and the front-end stage of
``fused_rx_block`` with ``cfg.mixer_fold`` (``_fused_rx_kernel_folded``)
against the port's plain versions, on the same seeded int16 rows, the
JAX kernels in interpret mode.

Tolerances.  JAX contracts the 2 x 49 bf16 products in matmul order, the
port in ascending tap order, and both then rotate in f32: f32 planes
agree to the reassociation of the sums (< 2e-5 at |y| < 2).  The
rotation ``mr * A - mi * B`` cancels, so a small output carries the
absolute error of its large sums: bf16 planes agree to one bf16 ulp of
the output plus that 2e-5.  One place is worse by nature.  A carried
downmixed tail un-rotates to the raw samples x = pcm / 16384 up to an
f32 ulp, and x sits on a bf16 rounding tie for about one sample in 128;
there the last bit of the un-rotation decides the rounding, and XLA on
the CPU fuses ``a * eur + b * eui`` into a multiply-add where PyTorch
rounds the products.  A flipped halo sample moves the outputs whose 49 taps reach
it (symbols 0..9 of a block) by one bf16 ulp of the sample times a tap:
those symbols are held to ``HALO_TOL`` = 3 flips of a full-scale sample
under the largest tap.  Decisions do not move (test_torch_rx_fold.py).
The new tail and phase are elementwise f32 in the JAX package's
operation order: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.ops import frontend_pallas as jfe
from singlecarrier_tpu.ops.fused_rx import fused_rx_block as jax_rx_block
from singlecarrier_tpu_torch.interop import config_from_dict
from singlecarrier_tpu_torch.ops import frontend
from singlecarrier_tpu_torch.ops.fused_rx import fused_rx_block

N = 8
HALO_SYMS = 10          # symbols whose taps reach the 48-sample halo


def _halo_tol(tcfg):
    ctaps = frontend._fold_tables(tcfg, torch.device("cpu"))[0]
    return 3 * 2.0 ** -9 * float(ctaps.abs().max())


def _assert_planes(got, want, bf16, tcfg):
    """``got`` (torch) against ``want`` (numpy f32) as the module
    docstring states; the symbol axis is last."""
    g = got.float().numpy()
    err = np.abs(g - want)
    body, head = err[..., HALO_SYMS:], err[..., :HALO_SYMS]
    if bf16:
        _, e = np.frexp(np.maximum(np.abs(want), 1e-30))
        assert np.all(body <= (np.ldexp(1.0, e - 8) + 2e-5)[..., HALO_SYMS:])
    else:
        assert body.max() < 2e-5, body.max()
    assert head.max() <= _halo_tol(tcfg), head.max()
    assert np.abs(want).max() > 0.5              # real signal went through


def _pcm(rng, shape):
    return rng.integers(-16384, 16384, shape).astype(np.int16)


@pytest.mark.parametrize("transposed", [True, False],
                         ids=["transposed", "rowmajor"])
@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_folded_rows_match_jax_across_a_carried_boundary(decim_dtype,
                                                         transposed):
    """The inputs of the JAX package's own fold test
    (tests/test_pallas_frontend.py): random unit phases, a zero halo,
    two blocks with the state carried between them."""
    cfg = CFG.replace(decim_dtype=decim_dtype)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(5)
    n = cfg.frame_size
    pcm = _pcm(rng, (N, 2 * n))
    th = rng.uniform(0, 2 * np.pi, N)
    st = [np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
          np.zeros((N, 48), np.float32), np.zeros((N, 48), np.float32)]
    bf16 = decim_dtype == "bf16" and transposed
    for blk in (pcm[:, :n], pcm[:, n:]):
        want = jfe.fused_frontend_decim(
            cfg, jnp.asarray(blk), *(jnp.asarray(a) for a in st),
            block_channels=N, transposed=transposed, mixer_fold=True,
            interpret=True)
        got = frontend.fused_frontend_decim(
            tcfg, torch.from_numpy(blk.copy()),
            *(torch.from_numpy(a.copy()) for a in st),
            transposed=transposed, mixer_fold=True)
        assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert tuple(got[0].shape) == want[0].shape
        _assert_planes(got[0], np.asarray(want[0].astype(jnp.float32)),
                       bf16, tcfg)
        # new tail (r, i) and new phase (r, i): exact
        for a, b in zip(want[1:], got[1:]):
            assert np.array_equal(np.asarray(a), b.numpy())
        st = [np.asarray(want[3]), np.asarray(want[4]),
              np.asarray(want[1]), np.asarray(want[2])]


def test_cfg_mixer_fold_is_the_default_of_the_argument():
    tcfg = config_from_dict(dataclasses.asdict(CFG.replace(mixer_fold=True)))
    rng = np.random.default_rng(6)
    pcm = torch.from_numpy(_pcm(rng, (N, CFG.frame_size)))
    th = torch.from_numpy(rng.uniform(0, 2 * np.pi, N).astype(np.float32))
    tl = torch.from_numpy((rng.normal(size=(N, 48)) * 0.3).astype(np.float32))
    args = (pcm, torch.cos(th), torch.sin(th), tl, tl.flip(0))
    by_cfg = frontend.fused_frontend_decim(tcfg, *args)[0]
    by_arg = frontend.fused_frontend_decim(
        tcfg.replace(mixer_fold=False), *args, mixer_fold=True)[0]
    premix = frontend.fused_frontend_decim(tcfg, *args, mixer_fold=False)[0]
    assert torch.equal(by_cfg, by_arg)
    # the fold is the same filter: past the halo (a random complex tail
    # is no downmixed real signal) it equals premix within bf16 noise
    assert not torch.equal(by_cfg, premix)
    diff = (by_cfg - premix)[..., HALO_SYMS:].abs().max()
    assert float(diff) < 2e-2


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_folded_one_kernel_front_end_matches_jax(decim_dtype, B):
    """The front-end stage of the one-kernel RX with ``cfg.mixer_fold``,
    read through the decim state it leaves (block B-1's planes): B = 1
    un-rotates the carried seed, B = 3 takes the halo from the previous
    block's raw PCM."""
    C = 4
    cfg = CFG.replace(decim_dtype=decim_dtype, mixer_fold=True)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    pcm = _pcm(rng, (B, C, cfg.frame_size))
    th = rng.uniform(0, 2 * np.pi, C)
    ops = [np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
           (rng.normal(size=(C, 48)) * 0.3).astype(np.float32),
           (rng.normal(size=(C, 48)) * 0.3).astype(np.float32)]
    ddt = jnp.bfloat16 if decim_dtype == "bf16" else jnp.float32
    shape = (cfg.cycles, 2, C, cfg.symbols_per_block)
    _, want, fin_j = jax_rx_block(
        cfg, jnp.asarray(pcm), *(jnp.asarray(a) for a in ops),
        jnp.zeros(shape, ddt), block_channels=C, interpret=True)
    tdt = torch.bfloat16 if decim_dtype == "bf16" else torch.float32
    _, got, fin_t = fused_rx_block(
        tcfg, torch.from_numpy(pcm), *(torch.from_numpy(a) for a in ops),
        torch.zeros(shape, dtype=tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    _assert_planes(got, np.asarray(want.astype(jnp.float32)),
                   decim_dtype == "bf16", tcfg)
    # the public tail state stays downmixed, the phase closed-form
    for a, b in zip(fin_j, fin_t):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
