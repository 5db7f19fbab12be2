"""What the premix front-end kernels' window form relies on, pinned on
the CPU.

No CUDA kernel runs here.  ``csrc/frontend.cu``'s ``window_sums`` gives a
thread a task (a few consecutive symbols of one plane of one row), lets it
load the task's inputs from shared memory once, and adds each input into
every accumulator it belongs to with a hand-written fused multiply-add,
under a build that otherwise forbids fusing (``-fmad=false``).  These
tests hold, in numpy and against the port's plain versions:

  * the exactness the fused form assumes: a tap (bf16 value) times a
    sample (bf16 value) is exact in f32 for u = 0 and every |u| >= 2^-100,
    for the premix taps at both roll-offs, and for the real and imaginary
    folded taps for |u| >= 2^-80; and where it ends (products that
    underflow);
  * a counter-case with f32 operands (the taps x gain of the full-rate
    front-end), where fused and unfused sums differ: the fused form must
    not be carried over there;
  * a model of the kernel's loop, task by task as the kernel deals them
    (task -> row, plane, first output; the window slid through an array
    that stands for the registers; ascending k; the output index of both
    layouts; a persistent grid whose last round of rows is ragged), equal to
    ``frontend_decim_ref`` / ``frontend_rows_ref`` to the bit;
  * the same for the mixer-folded pair (``folded_window_sums``): lanes 2j
    and 2j + 1 share a window and sum it against the real and the
    imaginary folded taps, swap their sums (the shuffle) and form yr and
    yi unfused, equal to ``frontend_decim_folded_ref`` /
    ``frontend_rows_folded_ref`` to the bit; and that an un-rotated halo
    carried from int16 PCM is 0 or far above the folded taps' 2^-80;
  * that the sources fuse nowhere else (``frontend_full``, whose operands
    are f32, takes the same loop unfused), and that every way into the
    two kernels refuses ``frontend_dtype="f32"``.

``tests/test_torch_frontend_full_window.py`` models ``frontend_full``'s
unfused loop.
"""

import re

import numpy as np
import pytest
import torch

from singlecarrier_tpu_torch import DEFAULT_CONFIG
from singlecarrier_tpu_torch.dsp.mixer import downmix_tail
from singlecarrier_tpu_torch.ops import _build, frontend
from singlecarrier_tpu_torch.ops.fused_rx import _advances

CPU = torch.device("cpu")
N_SAMP, N_SYM, CYC, NTAPS, HALO = 1880, 376, 5, 49, 48
SRC = (_build.CSRC / "frontend.cu").read_text()


def _win_syms(cyc: int) -> int:
    """The symbols of a task as ``csrc/frontend.cu`` states them for
    ``cyc`` cycles: its wide value above its cycle bound where the count
    is even, else its base value (2 and 4 above 5 cycles)."""
    above, wide, base = map(int, re.search(
        r"constexpr int WIN_SYMS = CYC > (\d+) && CYC % 2 == 0 \? (\d+) : "
        r"(\d+);", SRC).groups())
    return wide if cyc > above and cyc % 2 == 0 else base


# (symbols a task, blocks of the persistent grid, threads a block): the
# kernel's task size with a grid that leaves the last round of rows
# ragged, then others the same loop must serve
WIN_SYMS = _win_syms(CYC)
GEOMETRIES = sorted({(WIN_SYMS, 4, -(-2 * (N_SYM // WIN_SYMS) // 32) * 32),
                     (2, 1, 384), (4, 7, 192), (2, 4, 256)})


def _all_bf16():
    """Every finite bf16 value, as f32."""
    u = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return u[np.isfinite(u)]


def _taps(alpha: float, kind: str) -> np.ndarray:
    cfg = DEFAULT_CONFIG.replace(alpha=alpha)
    if kind == "premix":
        return frontend.decim_taps(cfg).numpy()
    ctaps = frontend._fold_tables(cfg, CPU)[0].numpy()
    return ctaps[0 if kind == "folded real" else 1]


def _inexact(w: np.ndarray, u: np.ndarray) -> np.ndarray:
    """[len(w), len(u)] bool: the f32 product differs from the true one
    (f64 holds a product of two f32 values exactly)."""
    p32 = w[:, None] * u[None, :]
    assert p32.dtype == np.float32
    return p32.astype(np.float64) != w.astype(np.float64)[:, None] * u.astype(
        np.float64)[None, :]


@pytest.mark.parametrize("kind", ["premix", "folded real", "folded imag"])
@pytest.mark.parametrize("alpha", [0.35, 0.50])
def test_tap_times_bf16_sample_is_exact_in_f32(alpha, kind):
    w = _taps(alpha, kind)
    assert w.shape == (NTAPS,) and w.dtype == np.float32
    # the taps are bf16 values themselves
    assert np.array_equal(
        w, torch.from_numpy(w).to(torch.bfloat16).float().numpy())
    if kind == "premix":                        # none zero
        assert np.abs(w).min() > (5e-4 if alpha == 0.35 else 6e-5)
    # one folded tap is 1.5e-16, where the cosine crosses zero: there the
    # product underflows sooner
    floor = 2.0 ** (-100 if kind == "premix" else -80)
    u = _all_bf16()
    u = u[(u == 0) | (np.abs(u) >= floor)]
    assert u.size > 52000
    assert not _inexact(w, u).any()


@pytest.mark.parametrize("kind", ["premix", "folded real", "folded imag"])
@pytest.mark.parametrize("ntaps", [9, 25, 43, 45])
def test_tap_times_bf16_sample_is_exact_at_other_tap_counts(ntaps, kind):
    """The fused tap loops hold at other RRC lengths the kernels take (43:
    a halo of 4k + 2 samples): the taps of 9, 25, 43 and 45 are bf16
    values too, and their products with
    every bf16 sample of 0 or |u| >= 2^-60 are exact in f32 (the
    smallest folded tap, 3.7e-18 at 25 taps, is smaller than at 49, so
    the bound is 2^-60, not 2^-80: still far under the 2^-15 that a
    sample of int16 PCM or an un-rotated carried halo reaches)."""
    cfg = DEFAULT_CONFIG.replace(ntaps=ntaps)
    w = (frontend.decim_taps(cfg) if kind == "premix" else
         frontend._fold_tables(cfg, CPU)[0][0 if kind == "folded real"
                                            else 1]).numpy()
    assert w.shape == (ntaps,) and w.dtype == np.float32
    assert np.array_equal(
        w, torch.from_numpy(w).to(torch.bfloat16).float().numpy())
    u = _all_bf16()
    u = u[(u == 0) | (np.abs(u) >= 2.0 ** -60)]
    assert not _inexact(w, u).any()


@pytest.mark.parametrize("alpha", [0.35, 0.50])
def test_exactness_ends_where_the_product_underflows(alpha):
    w = _taps(alpha, "premix")
    u = _all_bf16()
    bad = _inexact(w, u)
    assert bad.any()
    worst_u = np.abs(u)[bad.any(0)].max()
    # 2^-125 at alpha = 0.35 (smallest tap 5.4e-4), 2^-122 at 0.50 (6.3e-5):
    # some twenty orders of magnitude under any sample made from int16
    # PCM (|x| >= 2^-14 times a unit phasor times a table value)
    assert worst_u <= (2.36e-38 if alpha == 0.35 else 1.9e-37), worst_u
    prod = np.abs(w.astype(np.float64)[:, None] * u.astype(np.float64)[None])
    assert prod[bad].max() < 2.0 ** -126      # only subnormal products


def _fma(w, u, acc):
    """fmaf(w, u, acc) for f32 arrays: the product is exact in f64."""
    return (np.float64(w) * u.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def test_fused_sums_of_f32_operands_differ_from_unfused():
    """The full-rate front-end multiplies f32 taps by f32 samples: there
    the fused multiply-add returns other bits, so it stays unfused."""
    cfg = DEFAULT_CONFIG
    w = (frontend._full_taps(cfg, CPU)
         * torch.tensor(cfg.fir_gain, dtype=torch.float32)).numpy()
    rng = np.random.default_rng(5)
    u = rng.uniform(-1, 1, (4096, NTAPS)).astype(np.float32)
    assert _inexact(w, u[0]).any()
    fused = np.zeros(4096, np.float32)
    plain = np.zeros(4096, np.float32)
    for k in range(NTAPS):
        fused = _fma(w[k], u[:, k], fused)
        plain = plain + w[k] * u[:, k]
    assert plain.dtype == np.float32
    n_diff = int((fused != plain).sum())
    assert n_diff > 1000, n_diff
    # while bf16 operands on the same windows agree on every one
    wb = frontend.decim_taps(cfg).numpy()
    ub = torch.from_numpy(u).to(torch.bfloat16).float().numpy()
    fused = np.zeros(4096, np.float32)
    plain = np.zeros(4096, np.float32)
    for k in range(NTAPS):
        fused = _fma(wb[k], ub[:, k], fused)
        plain = plain + wb[k] * ub[:, k]
    assert np.array_equal(fused, plain)


# ------------------------------------------------- the kernel's loop

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


def _state(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, n)
    return (torch.from_numpy(np.cos(ph).astype(np.float32)),
            torch.from_numpy(np.sin(ph).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(n, HALO)) * 0.3)
                             .astype(np.float32)),
            torch.from_numpy((rng.normal(size=(n, HALO)) * 0.3)
                             .astype(np.float32)))


def _downmix(cfg, x16, t, pr, pi):
    """The kernels' downmix of samples ``x16`` at table indices ``t``
    with phase (pr, pi): bf16(x * (p * table[t])), product by product."""
    tr, ti = frontend._mixer_planes(cfg, CPU)
    x = x16.float() * (1.0 / cfg.tx_amplitude)
    zr = (x * (pr * tr[t] - pi * ti[t])).to(torch.bfloat16).float()
    zi = (x * (pr * ti[t] + pi * tr[t])).to(torch.bfloat16).float()
    return zr, zi


def _stage_rows(cfg, pcm, ph_r, ph_i, tail_r, tail_i):
    """u [N, 2, 1928] as ``frontend_rows_kernel`` stages it."""
    t = torch.arange(N_SAMP)
    zr, zi = _downmix(cfg, pcm, t, ph_r[:, None], ph_i[:, None])
    return torch.stack([
        torch.cat([tail_r.to(torch.bfloat16).float(), zr], -1),
        torch.cat([tail_i.to(torch.bfloat16).float(), zi], -1)], 1).numpy()


def _stage_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv):
    """u [B*C, 2, 1928] as ``frontend_decim_kernel`` stages it: every row
    on its own, the halo of a row with b > 0 recomputed from row n - C's
    raw tail with the phase p0 * adv^(b-1)."""
    B, C, _ = pcm.shape
    u = np.zeros((B * C, 2, HALO + N_SAMP), np.float32)
    t = torch.arange(N_SAMP)
    for row in range(B * C):
        b, ch = divmod(row, C)
        pr = p0r[ch] * adv[0, b] - p0i[ch] * adv[1, b]
        pi = p0r[ch] * adv[1, b] + p0i[ch] * adv[0, b]
        zr, zi = _downmix(cfg, pcm[b, ch], t, pr, pi)
        if row < C:
            hr = t0r[row].to(torch.bfloat16).float()
            hi = t0i[row].to(torch.bfloat16).float()
        else:
            sr = p0r[ch] * adv[0, b - 1] - p0i[ch] * adv[1, b - 1]
            si = p0r[ch] * adv[1, b - 1] + p0i[ch] * adv[0, b - 1]
            prev = pcm.reshape(B * C, N_SAMP)[row - C]
            hr, hi = _downmix(cfg, prev[N_SAMP - HALO:], t[N_SAMP - HALO:],
                              sr, si)
        u[row, 0] = torch.cat([hr, zr]).numpy()
        u[row, 1] = torch.cat([hi, zi]).numpy()
    return u


def _window_sums(cfg, u, row_major: bool, geometry):
    """``window_sums`` of ``csrc/frontend.cu`` for staged rows ``u``
    [N, 2, 1928]: block i of ``grid`` takes rows i, i + grid, ..; the
    tasks of a row are dealt to ``threads`` threads round by round."""
    syms, grid, threads = geometry
    win_t, tasks_plane = CYC * syms, N_SYM // syms
    win_len = win_t + HALO
    assert N_SYM % syms == 0
    w = frontend.decim_taps(cfg).numpy()
    N = u.shape[0]
    shape = (N, CYC, 2, N_SYM) if row_major else (CYC, 2, N, N_SYM)
    out = np.full(shape, np.nan, np.float32)
    stores = np.zeros(shape, np.int32)
    n_task = 2 * tasks_plane
    rows_of = [range(blk, N, grid) for blk in range(min(grid, N))]
    for row in (r for rows in rows_of for r in rows):
        for first in range(0, n_task, threads):      # one round of the loop
            task = np.arange(first, min(first + threads, n_task))
            p = task // tasks_plane
            j = task - p * tasks_plane
            # the registers: input m of every task of the round
            win = u[row, p[:, None],
                    win_t * j[:, None] + np.arange(win_len)[None]]
            acc = np.zeros((task.size, win_t), np.float32)
            for m in range(win_len):                 # each input once
                for i in range(win_t):
                    k = m - i
                    if 0 <= k < NTAPS:
                        acc[:, i] = _fma(w[k], win[:, m], acc[:, i])
            for c in range(CYC):
                for s in range(syms):
                    sym = syms * j + s
                    idx = ((row, c, p, sym) if row_major
                           else (c, p, row, sym))
                    out[idx] = acc[:, CYC * s + c]
                    np.add.at(stores, idx, 1)
    assert (stores == 1).all()                       # each output once
    return torch.from_numpy(out)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "%dx%dx%d" % g)
@pytest.mark.parametrize("pcm_kind", ["golden", "noise"])
@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_window_model_equals_frontend_decim_ref(decim_dtype, pcm_kind,
                                                geometry):
    cfg = DEFAULT_CONFIG.replace(decim_dtype=decim_dtype)
    B, C = 3, 2                                      # 6 rows on 4 or 7 blocks
    pcm = torch.from_numpy(_pcm(pcm_kind, B * C, 41)).reshape(B, C, N_SAMP)
    p0r, p0i, t0r, t0i = _state(C, 42)
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * N_SAMP * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag]))
    want = frontend.frontend_decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    u = _stage_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    got = _window_sums(cfg, u, False, geometry).to(want.dtype)
    assert want.dtype == frontend._DTYPES[decim_dtype]
    assert torch.equal(got, want)
    assert float(want.float().abs().max()) > 0.5


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "%dx%dx%d" % g)
@pytest.mark.parametrize("pcm_kind", ["golden", "noise"])
@pytest.mark.parametrize("layout", ["transposed f32", "transposed bf16",
                                    "row-major f32"])
def test_window_model_equals_frontend_rows_ref(layout, pcm_kind, geometry):
    cfg = DEFAULT_CONFIG.replace(decim_dtype=layout.split()[1])
    transposed = layout.startswith("transposed")
    N = 5                                            # rows on 4 or 7 blocks
    pcm = torch.from_numpy(_pcm(pcm_kind, N, 43))
    rows = (pcm, *_state(N, 44))
    want = frontend.frontend_rows_ref(cfg, *rows, transposed=transposed)
    u = _stage_rows(cfg, *rows)
    got = _window_sums(cfg, u, not transposed, geometry).to(want.dtype)
    assert torch.equal(got, want)


def test_rows_staged_with_the_batch_tails_equal_the_batch_staging():
    """The two kernels stage the same u when the per-row phases and tails
    are the ones ``prod_rx_batch`` derives: the recomputed halo is the
    rounded downmixed tail."""
    cfg = DEFAULT_CONFIG
    B, C = 3, 2
    pcm = torch.from_numpy(_pcm("noise", B * C, 45)).reshape(B, C, N_SAMP)
    p0r, p0i, t0r, t0i = _state(C, 46)
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * N_SAMP * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag]))
    ph_r = p0r[None] * adv[0][:, None] - p0i[None] * adv[1][:, None]
    ph_i = p0r[None] * adv[1][:, None] + p0i[None] * adv[0][:, None]
    x_t = pcm[:, :, N_SAMP - HALO:].float() * (1.0 / cfg.tx_amplitude)
    tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, N_SAMP, HALO, x_t,
                              ph_r[..., None], ph_i[..., None])
    u_rows = _stage_rows(
        cfg, pcm.reshape(B * C, N_SAMP), ph_r.reshape(-1), ph_i.reshape(-1),
        torch.cat([t0r[None], tl_r[:-1]]).reshape(B * C, HALO),
        torch.cat([t0i[None], tl_i[:-1]]).reshape(B * C, HALO))
    assert np.array_equal(u_rows,
                          _stage_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv))


# ------------------------------------------------- the folded pair's loop

def _bf16(x) -> np.ndarray:
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def _unrotate(cfg, tail_r, tail_i, pr, pi) -> np.ndarray:
    """``unrotate`` of ``csrc/frontend.cu``, product by product in f32:
    bf16(a eur + b eui), a = tr pr + ti pi, b = ti pr - tr pi."""
    eur, eui = frontend._fold_tables(cfg, CPU)[1].numpy()
    tr, ti = np.asarray(tail_r, np.float32), np.asarray(tail_i, np.float32)
    pr, pi = np.float32(pr), np.float32(pi)
    a = tr * pr + ti * pi
    b = ti * pr - tr * pi
    return _bf16(a * eur + b * eui)


def _raw(cfg, x16) -> np.ndarray:
    return _bf16(np.asarray(x16, np.float32)
                 * np.float32(1.0 / cfg.tx_amplitude))


def _stage_fold_rows(cfg, pcm, ph_r, ph_i, tail_r, tail_i):
    """u [N, 1928] as ``frontend_rows_folded_kernel`` stages it."""
    return np.stack([np.concatenate([
        _unrotate(cfg, tail_r[r].numpy(), tail_i[r].numpy(), ph_r[r],
                  ph_i[r]), _raw(cfg, pcm[r].numpy())])
        for r in range(pcm.shape[0])])


def _stage_fold_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv):
    """(u [B*C, 1928], phase_r [B*C], phase_i [B*C]) as
    ``frontend_decim_folded_kernel`` stages them: the phase p0 * adv^b,
    the halo of block 0 the carried tail un-rotated, of a row with b > 0
    row n - C's raw tail."""
    B, C, _ = pcm.shape
    u = np.zeros((B * C, HALO + N_SAMP), np.float32)
    ph = np.zeros((2, B * C), np.float32)
    for row in range(B * C):
        b, ch = divmod(row, C)
        pr = float(p0r[ch] * adv[0, b] - p0i[ch] * adv[1, b])
        pi = float(p0r[ch] * adv[1, b] + p0i[ch] * adv[0, b])
        halo = (_unrotate(cfg, t0r[ch].numpy(), t0i[ch].numpy(), pr, pi)
                if b == 0 else _raw(cfg, pcm[b - 1, ch, N_SAMP - HALO:]))
        u[row] = np.concatenate([halo, _raw(cfg, pcm[b, ch])])
        ph[:, row] = pr, pi
    return u, ph[0], ph[1]


def _fold_window_sums(cfg, u, ph_r, ph_i, row_major: bool, geometry):
    """``folded_window_sums`` of ``csrc/frontend.cu`` for staged rows
    ``u`` [N, 1928] with phases ``ph_*`` [N]: block i of ``grid`` takes
    rows i, i + grid, ..; lane l of a round takes window l // 2 against
    tap set l % 2 and swaps sums with lane l ^ 1."""
    syms, grid, threads = geometry
    win_t, n_win = CYC * syms, N_SYM // syms
    win_len = win_t + HALO
    assert threads % 2 == 0
    taps = frontend._fold_tables(cfg, CPU)[0].numpy()          # [2, 49]
    tab = frontend._mixer_planes(cfg, CPU).numpy()             # [2, 1880]
    N = u.shape[0]
    shape = (N, CYC, 2, N_SYM) if row_major else (CYC, 2, N, N_SYM)
    out = np.full(shape, np.nan, np.float32)
    stores = np.zeros(shape, np.int32)
    n_lane = 2 * n_win
    rows_of = [range(blk, N, grid) for blk in range(min(grid, N))]
    for row in (r for rows in rows_of for r in rows):
        pr, pi = np.float32(ph_r[row]), np.float32(ph_i[row])
        for first in range(0, n_lane, threads):      # one round of the loop
            lane = np.arange(first, min(first + threads, n_lane))
            j, q = lane // 2, lane % 2
            w = taps[q].astype(np.float64)           # each lane its tap set
            win = u[row, win_t * j[:, None] + np.arange(win_len)[None]]
            acc = np.zeros((lane.size, win_t), np.float32)
            for m in range(win_len):                 # each input once
                for i in range(win_t):
                    k = m - i
                    if 0 <= k < NTAPS:
                        acc[:, i] = (w[:, k] * win[:, m].astype(np.float64)
                                     + acc[:, i]).astype(np.float32)
            other = acc[np.arange(lane.size) ^ 1]    # the shuffle
            t = win_t * j[:, None] + np.arange(win_t)[None]
            mr = pr * tab[0][t] - pi * tab[1][t]
            mi = pr * tab[1][t] + pi * tab[0][t]
            y = mr * acc + np.where(q[:, None] == 1, mi, -mi) * other
            assert y.dtype == np.float32
            for c in range(CYC):
                for s_ in range(syms):
                    sym = syms * j + s_
                    idx = ((row, c, q, sym) if row_major
                           else (c, q, row, sym))
                    out[idx] = y[:, CYC * s_ + c]
                    np.add.at(stores, idx, 1)
    assert (stores == 1).all()                       # each output once
    return torch.from_numpy(out)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "%dx%dx%d" % g)
@pytest.mark.parametrize("pcm_kind", ["golden", "noise"])
@pytest.mark.parametrize("decim_dtype", ["f32", "bf16"])
def test_fold_window_model_equals_frontend_decim_folded_ref(
        decim_dtype, pcm_kind, geometry):
    cfg = DEFAULT_CONFIG.replace(decim_dtype=decim_dtype)
    B, C = 3, 2                                      # 6 rows on 4 or 7 blocks
    pcm = torch.from_numpy(_pcm(pcm_kind, B * C, 51)).reshape(B, C, N_SAMP)
    p0r, p0i, t0r, t0i = _state(C, 52)
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * N_SAMP * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag]))
    want = frontend.frontend_decim_folded_ref(cfg, pcm, p0r, p0i, t0r, t0i,
                                              adv)
    u, ph_r, ph_i = _stage_fold_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    got = _fold_window_sums(cfg, u, ph_r, ph_i, False, geometry)
    assert want.dtype == frontend._DTYPES[decim_dtype]
    assert torch.equal(got.to(want.dtype), want)
    assert float(want.float().abs().max()) > 0.5


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "%dx%dx%d" % g)
@pytest.mark.parametrize("pcm_kind", ["golden", "noise"])
@pytest.mark.parametrize("layout", ["transposed f32", "transposed bf16",
                                    "row-major f32"])
def test_fold_window_model_equals_frontend_rows_folded_ref(layout, pcm_kind,
                                                           geometry):
    cfg = DEFAULT_CONFIG.replace(decim_dtype=layout.split()[1])
    transposed = layout.startswith("transposed")
    N = 5                                            # rows on 4 or 7 blocks
    pcm = torch.from_numpy(_pcm(pcm_kind, N, 53))
    rows = (pcm, *_state(N, 54))
    want = frontend.frontend_rows_folded_ref(cfg, *rows,
                                             transposed=transposed)
    u = _stage_fold_rows(cfg, *rows)
    got = _fold_window_sums(cfg, u, rows[1].numpy(), rows[2].numpy(),
                            not transposed, geometry)
    assert torch.equal(got.to(want.dtype), want)


@pytest.mark.parametrize("carry", ["state_out", "batch"])
def test_unrotated_carried_halo_is_zero_or_far_above_the_fold_bound(carry):
    """Every int16 value at every halo position, carried as a downmixed
    tail the way the paths carry it and un-rotated with the phase that
    follows it: the halo sample is 0 exactly where the PCM is, and else
    at least 2^-15, so the fused folded sums (exact for |u| >= 2^-80)
    return the plain version's bits over it.  ``state_out``: the per-row
    front-end's new tail and normalised phase (``_frontend_state_out``,
    the streaming paths and the one-kernel path's carried seed);
    ``batch``: ``prod_rx_batch``'s tails of row n - C (``downmix_tail``
    with p0 adv^(b-1)), un-rotated with p0 adv^b."""
    cfg = DEFAULT_CONFIG
    v = np.arange(-32768, 32768, dtype=np.int32)
    x16 = v[(np.arange(v.size)[:, None] + 1361 * np.arange(HALO)[None])
            % v.size].astype(np.int16)               # each column all values
    assert all(np.unique(x16[:, m]).size == v.size for m in (0, 47))
    x16 = torch.from_numpy(x16)
    rng = np.random.default_rng(61)
    lo = np.inf
    for _ in range(3):
        th = rng.uniform(0, 2 * np.pi, v.size)
        p_r = torch.from_numpy(np.cos(th).astype(np.float32))
        p_i = torch.from_numpy(np.sin(th).astype(np.float32))
        if carry == "state_out":
            pcm = torch.zeros((v.size, N_SAMP), dtype=torch.int16)
            pcm[:, N_SAMP - HALO:] = x16
            _, t_r, t_i, n_r, n_i = frontend._frontend_state_out(
                cfg, None, pcm, p_r, p_i)
        else:
            a_r, a_i = _advances(cfg, 4096, CPU)[1]
            b = torch.from_numpy(rng.integers(1, 4096, v.size))
            s_r = p_r * a_r[b - 1] - p_i * a_i[b - 1]
            s_i = p_r * a_i[b - 1] + p_i * a_r[b - 1]
            n_r = p_r * a_r[b] - p_i * a_i[b]
            n_i = p_r * a_i[b] + p_i * a_r[b]
            x_t = x16.float() * (1.0 / cfg.tx_amplitude)
            t_r, t_i = downmix_tail(cfg.center, cfg.fs, N_SAMP, HALO, x_t,
                                    s_r[:, None], s_i[:, None])
        h = frontend._unrotate(cfg, t_r, t_i, n_r[:, None], n_i[:, None])
        h = h.float().numpy()
        assert np.array_equal(h == 0, x16.numpy() == 0)
        lo = min(lo, float(np.abs(h[h != 0]).min()))
    assert lo >= 2.0 ** -15, lo


# ------------------------------------------------- what the sources say

def _code(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)


def test_the_kernel_geometry_is_consistent():
    syms = WIN_SYMS
    assert N_SYM % syms == 0 and syms % 2 == 0
    vec = 4 if CYC * syms % 4 == 0 else 2            # floats a shared load
    assert (CYC * syms + HALO) % vec == 0
    # tasks CYC * syms floats apart: an odd number of load units, so the
    # lanes that share a load phase fall into different banks
    assert (CYC * syms // vec) % 2 == 1
    # the last task's window ends with the row's last input
    assert CYC * syms * (N_SYM // syms - 1) + CYC * syms + HALO \
        == HALO + N_SAMP


def test_only_the_premix_tap_loop_fuses():
    """The front-ends' one fused multiply-add is the FUSED branch of the
    tap loop ``tap_sums``.  Its callers are the premix pair's
    ``window_sums`` and the folded pair's ``folded_window_sums``, which
    take it as ``tap_sums<ROUND>`` -- fused only where the operands are
    bf16 values (``cfg.frontend_dtype="bf16"``: the entry points take
    the ``ROUND`` false instantiation for "f32") -- and only the four
    decimating kernels reach them.  ``frontend_full``'s loop is the other
    branch, each product and sum rounded on its own by ``__fmul_rn`` and
    ``__fadd_rn``, and its code names no fma.  Of the other sources only
    the decode's CFO DFT fuses, in ``mac<EXACT>``, which only its bf16
    instantiation takes (bf16 operands: exact products)."""
    assert "-fmad=false" in _build.NVCC_FLAGS
    code = _code(SRC)
    assert code.count("__fmaf_rn(") == 1 and code.count("fma") == 1
    body = code[code.index("template <bool FUSED>"):
                code.index("void store_task(")]
    assert "void tap_sums(" in body
    assert re.search(
        r"if constexpr \(FUSED\)\s*acc\[i\] = __fmaf_rn\(w\[k\], v\[e\], "
        r"acc\[i\]\);\s*else\s*acc\[i\] = __fadd_rn\(acc\[i\], "
        r"__fmul_rn\(w\[k\], v\[e\]\)\);", body)
    # the definition, two callers fused exactly for bf16 operands, one
    # unfused
    assert len(re.findall(r"\btap_sums\b", code)) == 4
    assert len(re.findall(r"\btap_sums<ROUND>\(", code)) == 2
    assert len(re.findall(r"\btap_sums<false>\(", code)) == 1
    premix = code[code.index("void window_sums("):
                  code.index("frontend_decim_kernel(")]
    assert "tap_sums<ROUND>(sm.w, &sm.u[p][WIN_T * j], acc);" in premix
    folded = code[code.index("void folded_window_sums("):
                  code.index("frontend_decim_folded_kernel(")]
    assert "tap_sums<ROUND>(sm.w[q], &sm.u[WIN_T * j], acc);" in folded
    # ROUND: every operand is rounded to bf16 on its way into shared
    # memory, and the entry points take ROUND false for f32 operands
    assert re.search(r"float fe_operand\(float x\) \{\s*if constexpr "
                     r"\(ROUND\) return bf16_round\(x\);\s*return x;", code)
    for launch in ("launch_decim", "launch_rows", "launch_decim_folded",
                   "launch_rows_folded"):
        assert f"(f32_operands ? {launch}<false> : {launch}<true>)(" in code
    # the fused callers' callers: the four decimating kernels, once each
    for callee, kernels in (
            ("window_sums<", ("frontend_decim_kernel(",
                              "frontend_rows_kernel(")),
            ("folded_window_sums<", ("frontend_decim_folded_kernel(",
                                     "frontend_rows_folded_kernel("))):
        calls = [m.start() for m in re.finditer(
            r"(?<![\w])" + re.escape(callee), code)]
        assert len(calls) == 2, callee
        starts = sorted(code.index(k) for k in kernels)
        assert starts[0] < calls[0] < starts[1] < calls[1], callee
    full = code[code.index("void full_window_sums("):
                code.index("unsigned persistent_grid(")]
    assert "tap_sums<false>(sm.in.w, &sm.in.u[p][WIN_T * j], acc);" in full
    assert "frontend_full_kernel(" in full
    assert "full_window_sums(sm, tid, out, row);" in full
    assert "fma" not in full and "tap_sums<ROUND>" not in full
    assert "window_sums<" not in full.replace("full_window_sums", "")
    for other in ("hunt.cu", "common.cuh"):
        text = _code((_build.CSRC / other).read_text())
        assert "fmaf" not in text and "__fma" not in text, other
    dec = _code((_build.CSRC / "decode.cu").read_text())
    assert dec.count("__fmaf_rn(") == 1
    assert len(re.findall(r"fma(?!xf)", dec)) == 1       # fmaxf is a max
    assert re.search(r"float mac\(float s, float a, float b\) \{\s*"
                     r"if constexpr \(EXACT\) return __fmaf_rn\(a, b, s\);"
                     r"\s*return s \+ a \* b;", dec)
    assert len(re.findall(r"\bmac<", dec)) == 8
    assert len(re.findall(r"\bmac<CFO16>\(", dec)) == 8
    assert "cfo_dft_block<(KNOBS & KNOB_CFO16) != 0>" in dec
    assert re.search(r"if constexpr \(CFO16\) \{\s*tr = bf16_round\(tr\);"
                     r"\s*ti = bf16_round\(ti\);", dec)


@pytest.mark.parametrize("entry", ["frontend_decim", "frontend_rows",
                                   "fused_frontend_decim"])
def test_every_way_into_the_kernels_checks_the_operand_dtype(entry):
    """The kernels round their operands to bf16 and fuse their tap sums
    only for ``frontend_dtype="bf16"``: every way into them hands the
    kernel the operand dtype (``f32_operands``), and the plain version
    under "f32" keeps the operands unrounded."""
    import inspect
    src = inspect.getsource(getattr(frontend, entry))
    if entry == "fused_frontend_decim":
        assert "frontend_rows(cfg, pcm" in src
    else:
        assert 'int(cfg.frontend_dtype == "f32")' in src
    f32 = DEFAULT_CONFIG.replace(frontend_dtype="f32")
    frontend._check_rows_config(f32)
    rows = (torch.from_numpy(_pcm("noise", 2, 45)), *_state(2, 46))
    a = frontend.frontend_rows(f32, *rows)
    b = frontend.frontend_rows(DEFAULT_CONFIG, *rows)
    assert a.dtype == b.dtype == torch.float32
    assert not torch.equal(a, b)
    assert float((a - b).abs().max()) < 1e-1 * float(b.abs().max())
