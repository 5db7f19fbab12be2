"""The full-rate front-end kernel's window form, modelled in numpy and
held to ``frontend_full_ref`` to the bit on the CPU.

No CUDA kernel runs here.  ``csrc/frontend.cu``'s ``frontend_full_kernel``
stages u = [halo | x * (p * table)] of a row in f32 (no bf16 rounding; the
halo as given), forms the taps w_k = taps[k] * gain in f32, and gives a
thread a task (p, j): the WIN_T = 5 * WIN_SYMS consecutive full-rate
outputs y[p][WIN_T j ..] of one plane, from the WIN_T + 48 inputs the
task reads once, in ascending m.  Each input is added into every
accumulator it belongs to, the product and the sum each rounded to f32 on
its own (``__fmul_rn``, ``__fadd_rn``).  The model below does the same,
task by task as the persistent grid deals them, and must equal the plain
version on golden-stream rows, on full-range int16 noise and on a second
block carrying the first block's tails and phases, at both roll-offs.
With the product and the sum fused, the same loop does not.
"""

import re

import numpy as np
import pytest
import torch

from singlecarrier_tpu_torch import DEFAULT_CONFIG
from singlecarrier_tpu_torch.ops import _build, frontend

CPU = torch.device("cpu")
N_SAMP, NTAPS, HALO = 1880, 49, 48
SRC = (_build.CSRC / "frontend.cu").read_text()
# the symbols of a task at 5 cycles: the base value of WIN_SYMS
WIN_SYMS = int(re.search(r"constexpr int WIN_SYMS = CYC > 5 && CYC % 2 == 0 "
                         r"\? \d+ : (\d+);", SRC).group(1))
WIN_T = 5 * WIN_SYMS
WIN_LEN = WIN_T + HALO
TASKS_PLANE = N_SAMP // WIN_T
# (blocks of the persistent grid, threads a block): the kernel's block
# with a grid that leaves the last round of rows ragged
GRID, THREADS = 4, -(-2 * TASKS_PLANE // 32) * 32


def _pcm(kind: str, n_rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":                       # full scale: saturated inputs
        return rng.integers(-32768, 32768, (n_rows, N_SAMP)).astype(np.int16)
    tx = np.load("tests/golden/reference.npz")["tx_pcm"].astype(np.float64)
    pcm = np.empty((n_rows, N_SAMP), np.int16)
    for r in range(n_rows):
        s = int(rng.integers(0, len(tx) - N_SAMP))
        x = tx[s:s + N_SAMP] + rng.normal(0, 800.0, N_SAMP)
        pcm[r] = np.clip(x, -32768, 32767).astype(np.int16)
    return pcm


def _rows(kind: str, n: int, seed: int):
    """(pcm, phase_r, phase_i, tail_r, tail_i) of ``n`` rows as torch
    tensors, as ``frontend_full`` takes them."""
    rng = np.random.default_rng(seed + 1)
    ph = rng.uniform(0, 2 * np.pi, n)
    return (torch.from_numpy(_pcm(kind, n, seed)),
            torch.from_numpy(np.cos(ph).astype(np.float32)),
            torch.from_numpy(np.sin(ph).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(n, HALO)) * 0.3)
                             .astype(np.float32)),
            torch.from_numpy((rng.normal(size=(n, HALO)) * 0.3)
                             .astype(np.float32)))


def _stage(cfg, pcm, ph_r, ph_i, tail_r, tail_i) -> np.ndarray:
    """u [N, 2, 1928] f32 as the kernel stages it: x = f32(pcm) *
    inv_scale, z_r = x * (pr tr - pi ti), z_i = x * (pr ti + pi tr), each
    product and difference rounded on its own, never to bf16; the halo
    copied as given."""
    tr, ti = frontend._mixer_planes(cfg, CPU).numpy()
    x = pcm.numpy().astype(np.float32) * np.float32(1.0 / cfg.tx_amplitude)
    pr, pi = ph_r.numpy()[:, None], ph_i.numpy()[:, None]
    zr = x * (pr * tr - pi * ti)
    zi = x * (pr * ti + pi * tr)
    assert zr.dtype == zi.dtype == np.float32
    return np.stack([np.concatenate([tail_r.numpy(), zr], -1),
                     np.concatenate([tail_i.numpy(), zi], -1)], 1)


def _taps(cfg) -> np.ndarray:
    w = (frontend._full_taps(cfg, CPU).numpy()
         * np.float32(cfg.fir_gain))
    assert w.dtype == np.float32 and w.shape == (NTAPS,)
    return w


def _window_model(cfg, u, fused: bool = False) -> np.ndarray:
    """``full_window_sums`` for staged rows ``u`` [N, 2, 1928]: block i
    of the grid takes rows i, i + GRID, ..; the 2 x TASKS_PLANE tasks of
    a row are dealt to THREADS threads round by round; task (p, j) slides
    its WIN_LEN inputs in ascending m into WIN_T accumulators, so each
    takes its 49 terms in ascending k from 0.  ``fused`` rounds product
    and sum once, as a fused multiply-add would (the product of two f32
    values is exact in f64)."""
    w = _taps(cfg)
    N = u.shape[0]
    out = np.full((N, 2, N_SAMP), np.nan, np.float32)
    stores = np.zeros(out.shape, np.int32)
    n_task = 2 * TASKS_PLANE
    for row in (r for blk in range(min(GRID, N))
                for r in range(blk, N, GRID)):
        for first in range(0, n_task, THREADS):      # one round of the loop
            task = np.arange(first, min(first + THREADS, n_task))
            p = task // TASKS_PLANE
            j = task - p * TASKS_PLANE
            # the registers: input m of every task of the round
            win = u[row, p[:, None], WIN_T * j[:, None]
                    + np.arange(WIN_LEN)[None]]
            acc = np.zeros((task.size, WIN_T), np.float32)
            for m in range(WIN_LEN):                 # each input once
                for i in range(max(0, m - NTAPS + 1), min(WIN_T, m + 1)):
                    k = m - i
                    if fused:
                        acc[:, i] = (np.float64(w[k]) * win[:, m]
                                     + acc[:, i]).astype(np.float32)
                    else:
                        acc[:, i] = acc[:, i] + w[k] * win[:, m]
            t = WIN_T * j[:, None] + np.arange(WIN_T)[None]
            out[row, p[:, None], t] = acc
            np.add.at(stores, (row, p[:, None], t), 1)
    assert (stores == 1).all()                       # each output once
    assert out.dtype == np.float32
    return out


def _carried(cfg, rows):
    """The second block's operands: new noise, with the tails and phases
    the first block's ``fused_frontend_ref`` carries out."""
    _, ntr, nti, npr, npi = frontend._frontend_state_out(
        cfg, None, rows[0], rows[1], rows[2])
    nxt = torch.from_numpy(_pcm("noise", rows[0].shape[0], 77))
    return nxt, npr, npi, ntr, nti


@pytest.mark.parametrize("block", ["first", "chained"])
@pytest.mark.parametrize("pcm_kind", ["golden", "noise"])
@pytest.mark.parametrize("alpha", [0.35, 0.50])
def test_window_model_equals_frontend_full_ref(alpha, pcm_kind, block):
    cfg = DEFAULT_CONFIG.replace(alpha=alpha)
    rows = _rows(pcm_kind, 5, 71)                    # 5 rows on 4 blocks
    if block == "chained":
        rows = _carried(cfg, rows)
        # a carried halo is f32, not a bf16 value
        assert not torch.equal(rows[3],
                               rows[3].to(torch.bfloat16).float())
    want = frontend.frontend_full_ref(cfg, *rows)
    assert want.dtype == torch.float32 and want.shape == (5, 2, N_SAMP)
    got = _window_model(cfg, _stage(cfg, *rows))
    assert np.array_equal(got, want.numpy())
    assert float(want.abs().max()) > 0.1


def test_fused_window_model_differs_from_frontend_full_ref():
    """The counter-case on the kernel's own loop: with each product and
    sum fused, the golden rows come out other on many outputs, so the
    unfused form is what returns the plain version's bits."""
    cfg = DEFAULT_CONFIG
    rows = _rows("golden", 2, 73)
    want = frontend.frontend_full_ref(cfg, *rows).numpy()
    fused = _window_model(cfg, _stage(cfg, *rows), fused=True)
    n_diff = int((fused != want).sum())
    assert n_diff > want.size // 20, n_diff
    assert np.abs(fused - want).max() < 1e-5 * np.abs(want).max()


def test_window_geometry_covers_a_row():
    """188 tasks of 20 outputs tile both planes of a row on one block of
    192 threads; each task's window is whole 16-byte units of shared
    memory; task t's outputs are floats 20 t .. 20 t + 19 of the row's
    [2][1880] (the kernel's row buffer takes them there as five float4
    writes), and the row is whole float4 units of the output."""
    assert 2 * TASKS_PLANE == 188 and THREADS == 192
    assert TASKS_PLANE * WIN_T == N_SAMP and WIN_LEN == 68
    assert WIN_T % 4 == 0 and WIN_LEN % 4 == 0 and (N_SAMP * 4) % 16 == 0
    task = np.arange(2 * TASKS_PLANE)
    p, j = task // TASKS_PLANE, task % TASKS_PLANE
    assert np.array_equal(p * N_SAMP + WIN_T * j, WIN_T * task)
    assert "float* y = sm.y + WIN_T * task;" in SRC
    # a thread a task (WIN_REP 1: 188 tasks, under 1024), task = tid
    assert re.search(r"constexpr int WIN_REP = \(WIN_TASKS \+ 1023\) / 1024;",
                     SRC)
    assert re.search(r"constexpr int WIN_THREADS =\s*\(\(WIN_TASKS \+ WIN_REP "
                     r"- 1\) / WIN_REP \+ 31\) / 32 \* 32;", SRC)
    assert "const int task = tid + WIN_THREADS * r;" in SRC
