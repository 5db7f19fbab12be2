"""Hunt, packet extraction and decode.

Counterparts of ``singlecarrier_tpu/ops/decode_pallas.py``:

  * :func:`hunt` -- the hunt of ``_hunt_decode_core`` (``:705-876``):
    the segmented PN correlation of the [2 zeros | prev | cur] window
    of every decimation phase (``cfg.hunt_dtype`` operands), the
    ``cfg.hunt_norm`` normalizer and the argmax over (phase, lag);
  * :func:`extract_decode` -- the packet extraction at the winning
    (phase, lag) (``:884-911``, a plain gather here) and
    ``_decode_core`` (``:398-597``): energy gate, CFO DFT (operands at
    ``cfg.cfo_dtype``), derotation, LS train, guarded refit (Gram by
    ``cfg.ls_gram``, the train b-vector by ``cfg.ls_bvec``), decode,
    guarded phase refine and descramble, packed into the [N, 256] f32
    layout of ``fused_rx.py:551-561``;
  * :func:`extract_gate` -- the same extraction, then ``_decode_core``
    truncated after its energy gate (``stage="gate"``, ``:417-427``):
    every slot zero but gated, energy and the hunt's three;
  * :func:`fused_hunt_decode_decim` -- the launcher of the same name
    (``:978``): the hunt, then ``extract_decode`` or (``stage="gate"``)
    ``extract_gate``;
  * :func:`fused_decode_extract` -- ``:1196``: extraction at a given
    (phase, lag) from padded hunt windows, then ``_decode_core``;
  * :func:`fused_decode` -- ``:626``: ``_decode_core`` on extracted
    packets.

Each wrapper launches its CUDA kernel (``csrc/hunt.cu``,
``csrc/decode.cu``, built for the config's geometry) for tensors on the
card, and refuses a config outside ``_build.kernel_limits`` on either
device; ``hunt_ref``,
``extract_decode_ref``, ``extract_gate_ref``,
``fused_decode_extract_ref`` and ``fused_decode_ref`` are the plain
versions, used for CPU tensors and
as the kernels' references.  The plain helpers keep the JAX names and
operation order; complex values travel as real/imag planes of shape
[N, width] (one row per block-channel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig
from ..constants import PREAMBLE_VALUES, scramble_dibit_mask
from ..dsp.fftops import dft_matrix
from . import _build

_F32 = torch.float32


def _geometry(cfg: ModemConfig):
    """(off, wp, pkt_len): window pad, hunt-window width, packet width
    (``fused_rx_block``'s constants)."""
    P, n_sym = cfg.preamble_length, cfg.symbols_per_block
    off = cfg.eq_length // 2
    klen = -(-(off + n_sym + P - 1) // 128) * 128
    need = (n_sym - 1) + cfg.pkt_window
    wp = -(-max(need, off + 2 * n_sym, klen) // 128) * 128
    return off, wp, cfg.pkt_window


def _windows(cfg: ModemConfig, decim, dprev0):
    """[cyc, 2, N, wp] f32 hunt windows [off zeros | prev | cur | pad];
    row n's previous block is row n - C, or ``dprev0`` for n < C."""
    off, wp, _ = _geometry(cfg)
    cyc, _, N, n_sym = decim.shape
    C = dprev0.shape[2]
    prev = torch.cat([dprev0.to(decim.dtype), decim[:, :, :N - C]], 2)
    z = decim.new_zeros
    return torch.cat([z((cyc, 2, N, off)), prev, decim,
                      z((cyc, 2, N, wp - off - 2 * n_sym))], -1).float()


def _sum(x):
    return torch.sum(x, dim=-1, keepdim=True)


# ---------------------------------------------------------------- hunt

def _hunt_operand(cfg: ModemConfig, wins):
    """The hunt operand of f32 windows: int8 mode clip(rint(s w), +/-127)
    (integers held in f32; a NaN becomes 0, as XLA's cast to int8 makes
    it), bf16 mode bf16(w), f32 mode w."""
    if cfg.hunt_dtype == "int8":
        q = torch.clamp(torch.round(wins * cfg.hunt_int8_scale),
                        -127.0, 127.0)
        return torch.where(torch.isnan(q), 0.0, q)
    if cfg.hunt_dtype == "bf16":
        return wins.to(torch.bfloat16).float()
    return wins


# cfg.hunt_norm -> the hunt kernel's NORM_* (csrc/hunt.cu)
_HUNT_NORMS = {"espan": 0, "energy": 1, "none": 2}


def _window_energy(cfg: ModemConfig, sq):
    """[N, n_lags] window energies sum_k sq[..., off + l + k], k < P, of
    squared planes ``sq`` [N, wp], summed directly in ascending k."""
    off, _, _ = _geometry(cfg)
    n_lags = cfg.symbols_per_block
    en = torch.zeros(sq.shape[:-1] + (n_lags,), dtype=_F32, device=sq.device)
    for k in range(cfg.preamble_length):
        en = en + sq[..., off + k:off + k + n_lags]
    return en


def _segment_corr(cfg: ModemConfig, x, pn, s: int):
    """[..., n_lags] correlation of PN segment ``s`` with the operand
    ``x`` [..., wp] at every lag, summed in ascending k in f32."""
    seg = cfg.preamble_length // cfg.corr_segments
    n_lags = cfg.symbols_per_block
    off = cfg.eq_length // 2
    corr = torch.zeros(x.shape[:-1] + (n_lags,), dtype=_F32,
                       device=x.device)
    for k in range(seg):
        st = off + s * seg + k
        corr = corr + x[..., st:st + n_lags] * pn[s * seg + k]
    return corr


def _hunt_core(cfg: ModemConfig, wins):
    """Hunt of ``_hunt_decode_core``: (lag, phase, peak) per row.

    ``wins``: [cyc, 2, N, wp] f32 windows.  The correlation of segment
    s at lag l is sum_k x[off + l + 16s + k] * pn[16s + k] over the
    hunt operand x (int8: clip(rint(16 w), +/-127); bf16: bf16(w); f32:
    w), summed in ascending k -- exact for int8, and the kernel's order
    for bf16 and f32.  power = sum_s (re^2 + im^2), added in ascending s.
    The statistic is power / (energy + 1e-12): under ``cfg.hunt_norm``
    "espan" the energy is the direct 128-term sum of the phase-summed
    squared planes, under "energy" that of each phase's own squares;
    under "none" the statistic is the power.  The peak is the power at
    the chosen (phase, lag) in every mode.
    """
    cyc, _, N, _ = wins.shape
    n_seg = cfg.corr_segments
    int8_hunt = cfg.hunt_dtype == "int8"
    x = _hunt_operand(cfg, wins)
    pn = torch.from_numpy(PREAMBLE_VALUES.astype(np.float32)).to(wins.device)
    pw = None
    for s in range(n_seg):
        corr = _segment_corr(cfg, x, pn, s)
        p2 = corr * corr
        blk = p2[:, 0] + p2[:, 1]                           # [cyc, N, lags]
        pw = blk if pw is None else pw + blk

    sq = wins[:, 0] * wins[:, 0] + wins[:, 1] * wins[:, 1]  # [cyc, N, wp]
    if cfg.hunt_norm == "espan":
        ssum = sq[0]
        for c in range(1, cyc):
            ssum = ssum + sq[c]
        en = [_window_energy(cfg, ssum)] * cyc
    elif cfg.hunt_norm == "energy":
        en = [_window_energy(cfg, sq[c]) for c in range(cyc)]
    else:
        en = None

    # first max over lags; strict > across ascending phases
    best_m = torch.full((N,), -1.0, dtype=_F32, device=wins.device)
    best_pk = torch.full((N,), -1.0, dtype=_F32, device=wins.device)
    best_lag = torch.zeros((N,), dtype=torch.int32, device=wins.device)
    best_ph = torch.zeros((N,), dtype=torch.int32, device=wins.device)
    for c in range(cyc):
        stat = pw[c] if en is None else pw[c] / (en[c] + 1e-12)
        idx = torch.argmax(stat, dim=-1)
        mx = torch.gather(stat, 1, idx[:, None])[:, 0]
        pk = torch.gather(pw[c], 1, idx[:, None])[:, 0]
        upd = mx > best_m
        best_m = torch.where(upd, mx, best_m)
        best_pk = torch.where(upd, pk, best_pk)
        best_lag = torch.where(upd, idx.to(torch.int32), best_lag)
        best_ph = torch.where(upd, torch.full_like(best_ph, c), best_ph)
    peak = 2.0 * best_pk
    if int8_hunt:
        peak = peak * np.float32(1.0 / (cfg.hunt_int8_scale ** 2))
    return best_lag, best_ph, peak


def hunt_ref(cfg: ModemConfig, decim, dprev0):
    """Plain PyTorch version of :func:`hunt`."""
    return _hunt_core(cfg, _windows(cfg, decim, dprev0))


def hunt(cfg: ModemConfig, decim, dprev0):
    """Preamble hunt over every row's [prev | cur] window.

    Args:
      decim:  [cycles, 2, N, n_sym] decim planes (``cfg.decim_dtype``),
              row n = b*C + ch.
      dprev0: [cycles, 2, C, n_sym] the carried planes of the block
              before row ch's first block.

    Returns (lag i32 [N], phase i32 [N], peak f32 [N]).
    """
    _build.kernel_limits(cfg)
    if decim.device.type == "cpu":
        return hunt_ref(cfg, decim, dprev0)
    _check_planes(cfg, decim, dprev0)
    N, C = decim.shape[2], dprev0.shape[2]
    dev = decim.device
    lag = torch.empty((N,), dtype=torch.int32, device=dev)
    ph = torch.empty((N,), dtype=torch.int32, device=dev)
    peak = torch.empty((N,), dtype=_F32, device=dev)
    pn = _pn(dev)
    int8_hunt = cfg.hunt_dtype == "int8"
    peak_scale = (float(np.float32(1.0 / cfg.hunt_int8_scale ** 2))
                  if int8_hunt else 1.0)
    ptrs = _build.cuda_args(decim, dprev0, pn, lag, ph, peak, device=dev)
    if ptrs[0] % 16 or ptrs[1] % 16:
        raise ValueError("the hunt kernel reads the planes in 16-byte "
                         "words: decim and dprev0 must be 16-byte aligned")
    err = _build.load(cfg).sc_hunt(
        *ptrs, N, C, int(decim.dtype == torch.bfloat16),
        int(int8_hunt), float(cfg.hunt_int8_scale), peak_scale,
        int(cfg.hunt_dtype == "f32"), _HUNT_NORMS[cfg.hunt_norm],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hunt")
    _build.LAUNCHES["hunt"] += 1
    return lag, ph, peak


def _check_planes(cfg: ModemConfig, decim, dprev0):
    cyc, two, N, n_sym = decim.shape
    C = dprev0.shape[2]
    if (cyc, two, n_sym) != (cfg.cycles, 2, cfg.symbols_per_block) or \
            tuple(dprev0.shape) != (cyc, 2, C, n_sym) or N % C:
        raise ValueError(f"bad plane shapes {tuple(decim.shape)}, "
                         f"{tuple(dprev0.shape)}")
    if decim.dtype not in (torch.float32, torch.bfloat16) or \
            dprev0.dtype != decim.dtype:
        raise TypeError(f"planes must share f32|bf16, got {decim.dtype}, "
                        f"{dprev0.dtype}")


# ------------------------------------------------------ decode helpers

def _solve_chol(A_r, A_i, b_r, b_i, L):
    """Unrolled complex Cholesky solve on [N, 1]-shaped scalars
    (``decode_pallas._solve_chol``)."""
    c_r = [[None] * L for _ in range(L)]
    c_i = [[None] * L for _ in range(L)]
    for j in range(L):
        s = A_r[(j, j)]
        for k in range(j):
            s = s - (c_r[j][k] * c_r[j][k] + c_i[j][k] * c_i[j][k])
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        c_r[j][j] = d
        c_i[j][j] = torch.zeros_like(d)
        inv = 1.0 / d
        for i in range(j + 1, L):
            tr, ti = A_r[(i, j)], A_i[(i, j)]
            for k in range(j):
                tr = tr - (c_r[i][k] * c_r[j][k] + c_i[i][k] * c_i[j][k])
                ti = ti - (c_i[i][k] * c_r[j][k] - c_r[i][k] * c_i[j][k])
            c_r[i][j] = tr * inv
            c_i[i][j] = ti * inv

    y_r, y_i = [None] * L, [None] * L
    for i in range(L):
        tr, ti = b_r[i], b_i[i]
        for k in range(i):
            tr = tr - (c_r[i][k] * y_r[k] - c_i[i][k] * y_i[k])
            ti = ti - (c_r[i][k] * y_i[k] + c_i[i][k] * y_r[k])
        inv = 1.0 / c_r[i][i]
        y_r[i], y_i[i] = tr * inv, ti * inv

    x_r, x_i = [None] * L, [None] * L
    for i in reversed(range(L)):
        tr, ti = y_r[i], y_i[i]
        for k in range(i + 1, L):
            tr = tr - (c_r[k][i] * x_r[k] + c_i[k][i] * x_i[k])
            ti = ti - (c_r[k][i] * x_i[k] - c_i[k][i] * x_r[k])
        inv = 1.0 / c_r[i][i]
        x_r[i], x_i[i] = tr * inv, ti * inv
    return x_r, x_i


def _gram_sliding(pr, pi, L, count):
    """Gram via lag products + prefix-corrected partial sums
    (``decode_pallas._gram_sliding``): entries with lag d = i - j sum
    g_d[u] = conj(w[u]) w[u+d] over the window [j, j+count)."""
    W = pr.shape[-1]
    A_r, A_i = {}, {}
    for d in range(L):
        a_r, a_i = pr[:, :W - d], pi[:, :W - d]
        b_r, b_i = pr[:, d:], pi[:, d:]
        g_r = a_r * b_r + a_i * b_i
        g_i = (a_r * b_i - a_i * b_r) if d else None
        s_r = _sum(g_r[:, :count])
        s_i = _sum(g_i[:, :count]) if d else None
        A_r[(d, 0)] = s_r
        if d:
            A_i[(d, 0)] = -s_i
        for j in range(1, L - d):
            s_r = (s_r - g_r[:, j - 1:j]
                   + g_r[:, count + j - 1:count + j])
            A_r[(d + j, j)] = s_r
            if d:
                s_i = (s_i - g_i[:, j - 1:j]
                       + g_i[:, count + j - 1:count + j])
                A_i[(d + j, j)] = -s_i
    for i in range(L):
        A_i[(i, i)] = torch.zeros_like(A_r[(i, i)])
    return A_r, A_i


def _gram_direct(pr, pi, L, count):
    """Gram as L(L+1)/2 independent products and reductions
    (``decode_pallas._gram_direct``): A[i][j] = sum_t conj(w[t+i])
    w[t+j] over t < count, lower triangle."""
    sl_r = [pr[:, i:i + count] for i in range(L)]
    sl_i = [pi[:, i:i + count] for i in range(L)]
    A_r, A_i = {}, {}
    for i in range(L):
        for j in range(i + 1):
            A_r[(i, j)] = _sum(sl_r[i] * sl_r[j] + sl_i[i] * sl_i[j])
            A_i[(i, j)] = _sum(sl_r[i] * sl_i[j] - sl_i[i] * sl_r[j])
    return A_r, A_i


def _pn_bvec(pr, pi, pn, L):
    """The train fit's b-vector in its matmul form
    (``decode_pallas._pn_bvec_band``): b[i] = sum_u conj(w[u]) pn[u - i],
    the band's nonzero terms only, summed in ascending u as the kernel
    sums them; pn is [1, P].  Returns the lists of [N, 1] planes."""
    b_r = torch.zeros_like(pr[:, :L])
    b_i = torch.zeros_like(b_r)
    for k in range(pn.shape[-1]):
        b_r = b_r + pr[:, k:k + L] * pn[:, k:k + 1]
        b_i = b_i + (-pi[:, k:k + L]) * pn[:, k:k + 1]
    return ([b_r[:, i:i + 1] for i in range(L)],
            [b_i[:, i:i + 1] for i in range(L)])


def _fit(pr, pi, target_r, target_i, L, reg, count, offtap, *,
         gram: str = "sliding", pn_bvec: bool = False):
    """LS fit of sum_i coeff_i * w[t+i] ~ target[t] over t < count
    (``decode_pallas._fit``); ``target_i`` None means a real target.
    ``gram`` is ``cfg.ls_gram``; ``pn_bvec`` takes the b-vector of a
    real (PN) target in its matmul form (``cfg.ls_bvec="matmul"``), else
    the reduce form."""
    sl_r = [pr[:, i:i + count] for i in range(L)]
    sl_i = [pi[:, i:i + count] for i in range(L)]
    if gram == "direct":
        A_r, A_i = _gram_direct(pr, pi, L, count)
    else:
        A_r, A_i = _gram_sliding(pr, pi, L, count)
    tr_mean = A_r[(0, 0)]
    for i in range(1, L):
        tr_mean = tr_mean + A_r[(i, i)]
    ridge_c = reg * tr_mean / L + 1e-12
    ridge_o = offtap * tr_mean / L + 1e-12
    for i in range(L):
        A_r[(i, i)] = A_r[(i, i)] + (ridge_c if i == L // 2 else ridge_o)
    if pn_bvec:
        return _solve_chol(A_r, A_i, *_pn_bvec(pr, pi, target_r, L), L)
    b_r, b_i = [], []
    for i in range(L):
        if target_i is None:
            b_r.append(_sum(sl_r[i] * target_r))
            b_i.append(_sum(-sl_i[i] * target_r))
        else:
            b_r.append(_sum(sl_r[i] * target_r + sl_i[i] * target_i))
            b_i.append(_sum(sl_r[i] * target_i - sl_i[i] * target_r))
    return _solve_chol(A_r, A_i, b_r, b_i, L)


def _apply(pr, pi, cr, ci, L, count):
    """raw[t] = sum_i coeff_i * w[t+i]; returns planes [N, count]."""
    ar = torch.zeros_like(pr[:, :count])
    ai = torch.zeros_like(ar)
    for i in range(L):
        wr = pr[:, i:i + count]
        wi = pi[:, i:i + count]
        ar = ar + cr[i] * wr - ci[i] * wi
        ai = ai + cr[i] * wi + ci[i] * wr
    return ar, ai


def _apply_real(pr, pi, cr, ci, L, count):
    """Real plane of ``_apply`` only (identical operation order)."""
    ar = torch.zeros_like(pr[:, :count])
    for i in range(L):
        ar = ar + cr[i] * pr[:, i:i + count] - ci[i] * pi[:, i:i + count]
    return ar


def _cossin_small(x):
    """cos/sin via Taylor polynomials, valid for |x| <= ~0.8 rad (the
    refine corrections are clamped to pi/8)."""
    x2 = x * x
    c = 1.0 + x2 * (-0.5 + x2 * np.float32(1.0 / 24.0))
    s = x * (1.0 + x2 * (np.float32(-1.0 / 6.0)
                         + x2 * np.float32(1.0 / 120.0)))
    return c, s


def _slice_hard(ar, ai):
    """QPSK decisions in the raw domain: sym = raw*(1+j)."""
    i_bit = (ar - ai) < 0.0
    q_bit = (ar + ai) < 0.0
    hi = torch.where(i_bit, -1.0, 1.0)
    hq = torch.where(q_bit, -1.0, 1.0)
    hr = 0.5 * (hi + hq)
    hh = 0.5 * (hq - hi)
    dib = i_bit.to(_F32) * 2.0 + q_bit.to(_F32)
    return dib, hr, hh


def _dft_ascending(tr, ti, wr, wi):
    """(re, im) [N, nfft] of the CFO DFT of operands ``tr``, ``ti`` [N, P]
    against the table ``wr``, ``wi`` [P, nfft], its four sums run in
    ascending k, each product rounded before its sum, as the decode
    kernels run them: the kernel's powers to the bit.  On the card the
    plain decode sums so (a matmul's own order would reach the CFO through
    the parabola's step, the ratio of two small power differences: at 4096
    bins 1e-4 Hz, and the derotated packet's last symbols move by 1e-4 of
    their magnitude); on the CPU, where it is held to the JAX package by
    decisions, it takes the matmul, some 30 times faster."""
    s1 = s2 = s3 = s4 = torch.zeros((tr.shape[0], wr.shape[1]), dtype=_F32,
                                    device=tr.device)
    for k in range(tr.shape[1]):
        a, b = tr[:, k:k + 1], ti[:, k:k + 1]
        s1 = s1 + a * wr[k]
        s2 = s2 + b * wi[k]
        s3 = s3 + a * wi[k]
        s4 = s4 + b * wr[k]
    return s1 - s2, s3 + s4


# (row, bin) elements of one chunk of rows of the plain DFT on the card:
# its sums and temporaries stay a few GiB at 32768 bins
_DFT_CHUNK = 1 << 26


def _peak_of(pw):
    """(first maximum's bin [N, 1], the power there, and at the bins
    either side mod nfft) of the powers ``pw`` [N, nfft]."""
    nfft = pw.shape[1]
    kbin_i = torch.argmax(pw, dim=-1, keepdim=True)
    return (kbin_i, torch.gather(pw, 1, kbin_i),
            torch.gather(pw, 1, (kbin_i - 1) % nfft),
            torch.gather(pw, 1, (kbin_i + 1) % nfft))


def _peak_ascending(tr, ti, wr, wi, keep):
    """:func:`_peak_of` the powers of :func:`_dft_ascending` on the rows
    ``keep`` [N, 1] selects, zeros on the others (the decode's CFO is 0 on
    a row the energy gate does not pass, whatever its peak: on noise
    that is nearly every row), over the rows in chunks of at most
    ``_DFT_CHUNK`` (row, bin) elements: each row's sums keep their
    order."""
    idx = torch.nonzero(keep[:, 0]).squeeze(1)
    out = (torch.zeros((tr.shape[0], 1), dtype=torch.int64, device=tr.device),
           *(torch.zeros((tr.shape[0], 1), dtype=_F32, device=tr.device)
             for _ in range(3)))
    rows = max(1, _DFT_CHUNK // wr.shape[1])
    for i in range(0, idx.shape[0], rows):
        at = idx[i:i + rows]
        sr, si = _dft_ascending(tr[at], ti[at], wr, wi)
        for o, part in zip(out, _peak_of(sr * sr + si * si)):
            o[at] = part
    return out


def _decode_core(cfg: ModemConfig, pr0, pi0, peak, mask, *,
                 soft: bool = False):
    """``decode_pallas._decode_core`` on aligned packet planes.

    pr0/pi0: [N, pkt_window] (first chip at eq_length//2); peak: [N, 1];
    mask: [D] descramble dibit masks.  Returns the [N, D + 5] head of
    the packed output (dibits, matches, eq_error, cfo, gated, energy);
    with ``soft`` also the [N, D] real and imaginary soft symbols the
    dibits were sliced from.
    """
    P, D, L = cfg.preamble_length, cfg.frame_symbols, cfg.eq_length
    off = L // 2
    nfft, rs = cfg.cfo_nfft, cfg.rs
    dev = pr0.device
    if pr0.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain decode needs true f32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 "
                           "= False")
    pn = torch.from_numpy(PREAMBLE_VALUES.astype(np.float32)).to(dev)[None]
    chips_r = pr0[:, off:off + P]
    chips_i = pi0[:, off:off + P]
    energy = _sum(chips_r * chips_r + chips_i * chips_i)
    gated = peak > energy * cfg.effective_peak_gate

    # ---- CFO search: DFT + parabolic peak ----
    wr, wi = (t.to(dev) for t in _dft_table(cfg))
    tr = chips_r * pn
    ti = chips_i * pn
    if cfg.cfo_dtype == "bf16":           # exact products, f32 sums
        tr = tr.to(torch.bfloat16).float()
        ti = ti.to(torch.bfloat16).float()
    if tr.is_cuda:           # the kernel's reference: its sum order
        kbin_i, p0, pm, pp = _peak_ascending(tr, ti, wr, wi, gated)
    else:                    # held to JAX by decisions: a matmul
        sr = tr @ wr - ti @ wi
        si = tr @ wi + ti @ wr
        kbin_i, p0, pm, pp = _peak_of(sr * sr + si * si)
    denom = pm - 2.0 * p0 + pp
    delta = torch.where(torch.abs(denom) > 1e-20,
                        0.5 * (pm - pp) / denom, 0.0)
    kf = kbin_i.to(_F32) + delta
    kf = torch.where(kf > nfft / 2.0, kf - nfft, kf)
    cfo = kf * (rs / nfft)
    cfo = torch.where(gated, cfo, 0.0)

    # ---- de-rotate the packet ----
    n_all = pr0.shape[-1]
    t_idx = torch.arange(n_all, dtype=_F32, device=dev)[None] - off
    ang = np.float32(-2.0 * np.pi / rs) * cfo * t_idx
    rc = torch.cos(ang)
    rsn = torch.sin(ang)
    pr = pr0 * rc - pi0 * rsn
    pi_ = pr0 * rsn + pi0 * rc

    # ---- LS train on the preamble (real target pn) ----
    win_r = pr[:, :P + L - 1]
    win_i = pi_[:, :P + L - 1]
    cr, ci = _fit(win_r, win_i, pn, None, L, cfg.ls_reg, P,
                  cfg.ls_offtap_reg, gram=cfg.ls_gram,
                  pn_bvec=cfg.ls_bvec == "matmul")
    vr = _apply_real(win_r, win_i, cr, ci, L, P)
    matches = _sum((vr * pn > 0.0).to(_F32))

    # ---- guarded decision-directed refit on the first R data ----
    R = cfg.ls_refit_symbols or D
    dstart = off + P - (L // 2)
    dat_r = pr[:, dstart:dstart + D + L - 1]
    dat_i = pi_[:, dstart:dstart + D + L - 1]
    rdat_r = dat_r[:, :R + L - 1]
    rdat_i = dat_i[:, :R + L - 1]
    for _ in range(cfg.ls_refit_iters):
        ar, ai = _apply(rdat_r, rdat_i, cr, ci, L, R)
        _, hr, hh = _slice_hard(ar, ai)
        mag_raw = _sum(torch.sqrt(ar * ar + ai * ai)) / R
        mag_h = _sum(torch.sqrt(hr * hr + hh * hh)) / R + 1e-12
        scale = mag_raw / mag_h
        cr2, ci2 = _fit(rdat_r, rdat_i, hr * scale, hh * scale, L,
                        1e-3, R, cfg.ls_offtap_reg_refit, gram=cfg.ls_gram)
        vr2 = _apply_real(win_r, win_i, cr2, ci2, L, P)
        m2 = _sum((vr2 * pn > 0.0).to(_F32))
        keep = (m2 >= matches).to(_F32)
        cr = [keep * a + (1.0 - keep) * b for a, b in zip(cr2, cr)]
        ci = [keep * a + (1.0 - keep) * b for a, b in zip(ci2, ci)]

    # ---- decode + clamped GUARDED phase/frequency refinement ----
    def _derr(xr, xi):
        dib_, hrr, hhh = _slice_hard(xr, xi)
        mg = _sum(torch.sqrt(xr * xr + xi * xi)) / D + 1e-9
        er = xr / mg - hrr
        ei = xi / mg - hhh
        return _sum(torch.sqrt(er * er + ei * ei)), dib_, hrr, hhh

    ar, ai = _apply(dat_r, dat_i, cr, ci, L, D)
    a_max = np.float32(np.pi / 8.0)
    b_max = np.float32(np.pi / 8.0 / D)
    kd = torch.arange(D, dtype=_F32, device=dev)[None]
    if cfg.phase_refine_iters:
        cur_err, dib, hr, hh = _derr(ar, ai)
    for _ in range(cfg.phase_refine_iters):
        zr = ar * hr + ai * hh
        zi = ai * hr - ar * hh
        incr = _sum(zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1])
        inci = _sum(zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1])
        b = torch.clamp(inci / (torch.abs(incr) + 1e-20), -b_max, b_max)
        angd = -b * kd
        dc, dsn = _cossin_small(angd)
        zr2 = zr * dc - zi * dsn
        zi2 = zr * dsn + zi * dc
        z0r = _sum(zr2)
        z0i = _sum(zi2)
        a = torch.clamp(z0i / (torch.abs(z0r) + 1e-20), -a_max, a_max)
        ang2 = -a - b * kd
        c2, s2 = _cossin_small(ang2)
        ar2, ai2 = ar * c2 - ai * s2, ar * s2 + ai * c2
        new_err, dib2, hr2, hh2 = _derr(ar2, ai2)
        keep = (new_err <= cur_err).to(_F32)
        cur_err = keep * new_err + (1.0 - keep) * cur_err
        ar = keep * ar2 + (1.0 - keep) * ar
        ai = keep * ai2 + (1.0 - keep) * ai
        dib = keep * dib2 + (1.0 - keep) * dib
        hr = keep * hr2 + (1.0 - keep) * hr
        hh = keep * hh2 + (1.0 - keep) * hh
    if cfg.phase_refine_iters:
        eq_err = cur_err * np.float32(1.0 / D)
    else:
        dib, hr, hh = _slice_hard(ar, ai)
        mag = _sum(torch.sqrt(ar * ar + ai * ai)) / D + 1e-9
        err_r = ar / mag - hr
        err_i = ai / mag - hh
        eq_err = _sum(torch.sqrt(err_r * err_r + err_i * err_i)) / D

    # ---- descramble (XOR of the {0..3} dibits) ----
    di = dib.to(torch.int32)
    mi = mask.to(torch.int32)[None]
    dscr = (((di // 2 + mi // 2) % 2) * 2 + (di % 2 + mi % 2) % 2).to(_F32)
    head = torch.cat([dscr, matches, eq_err, cfo, gated.to(_F32), energy],
                     dim=1)
    return (head, ar, ai) if soft else head


@functools.lru_cache(maxsize=4)
def _mask_np(D: int, descramble: bool) -> np.ndarray:
    if descramble:
        return scramble_dibit_mask()[:D].astype(np.float32)
    return np.zeros(D, np.float32)


def _extract_from_planes(cfg: ModemConfig, decim, dprev0, lag, phase):
    """[N, 2, pkt_window] f32 packets at each row's (phase, lag) of its
    [prev | cur] window."""
    _, _, pkt_len = _geometry(cfg)
    wins = _windows(cfg, decim, dprev0)                     # [cyc, 2, N, wp]
    N = wins.shape[2]
    rows = torch.arange(N, device=wins.device)
    sel = wins[phase.long(), :, rows]                       # [N, 2, wp]
    idx = lag.long()[:, None] + torch.arange(pkt_len, device=wins.device)
    return torch.gather(sel, 2, idx[:, None].expand(N, 2, pkt_len))


def _hunt_tail(lag, phase, peak):
    return torch.stack([lag.to(_F32), phase.to(_F32), peak], dim=1)


def extract_decode_ref(cfg: ModemConfig, decim, dprev0, lag, phase, peak,
                       *, descramble: bool = True):
    """Plain PyTorch version of :func:`extract_decode`.

    Its CFO DFT depends on the device (``_decode_core``): on CUDA tensors
    it sums in ascending k (``_dft_ascending``, the kernels' order and
    their powers to the bit, 128 small steps), on the CPU it is a matmul
    (the code the CPU tests hold to the JAX package).  Timed on the card
    (``tools/_measure.kernel_calls``' plain_ms) it is the loop.
    """
    pkt = _extract_from_planes(cfg, decim, dprev0, lag, phase)
    mask = torch.from_numpy(_mask_np(cfg.frame_symbols, descramble))
    head = _decode_core(cfg, pkt[:, 0], pkt[:, 1], peak[:, None],
                        mask.to(pkt.device))
    return torch.cat([head, _hunt_tail(lag, phase, peak)], dim=1)


def extract_gate_ref(cfg: ModemConfig, decim, dprev0, lag, phase, peak):
    """Plain PyTorch version of :func:`extract_gate`."""
    P, D, off = cfg.preamble_length, cfg.frame_symbols, cfg.eq_length // 2
    pkt = _extract_from_planes(cfg, decim, dprev0, lag, phase)
    chips_r = pkt[:, 0, off:off + P]
    chips_i = pkt[:, 1, off:off + P]
    energy = _sum(chips_r * chips_r + chips_i * chips_i)
    gated = peak[:, None] > energy * cfg.effective_peak_gate
    return torch.cat([energy.new_zeros((energy.shape[0], D + 3)),
                      gated.to(_F32), energy, _hunt_tail(lag, phase, peak)],
                     dim=1)


def _extract_operands(cfg: ModemConfig, decim, dprev0, lag, phase, peak):
    """Check the operands the extraction kernels share; return (N, C, out)."""
    _check_planes(cfg, decim, dprev0)
    N, C = decim.shape[2], dprev0.shape[2]
    _check_row_stats(N, lag, phase, peak)
    return N, C, torch.empty((N, cfg.frame_symbols + 8), dtype=_F32,
                             device=decim.device)


def extract_decode(cfg: ModemConfig, decim, dprev0, lag, phase, peak, *,
                   descramble: bool = True):
    """Extract each row's packet at its hunt (phase, lag) and decode it.

    Args are :func:`hunt`'s planes and results.  Returns the packed
    [N, frame_symbols + 8] f32 stats: descrambled dibits, matches,
    eq_error, cfo_hz, gated, energy, lag, phase, peak.
    """
    _build.kernel_limits(cfg)
    if decim.device.type == "cpu":
        return extract_decode_ref(cfg, decim, dprev0, lag, phase, peak,
                                  descramble=descramble)
    dev = decim.device
    N, C, out = _extract_operands(cfg, decim, dprev0, lag, phase, peak)
    ptrs = _build.cuda_args(decim, dprev0, lag, phase, peak,
                            *_decode_tables(cfg, descramble, dev), out,
                            device=dev)
    err = _build.load(cfg).sc_extract_decode(
        *ptrs, N, C, int(decim.dtype == torch.bfloat16),
        *_build.decode_params(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "extract_decode")
    _build.LAUNCHES["extract_decode"] += 1
    return out


def extract_gate(cfg: ModemConfig, decim, dprev0, lag, phase, peak):
    """Phase 1 of the detection-gated RX: :func:`extract_decode`'s
    extraction and energy gate without its decode tail.  Returns the
    packed [N, frame_symbols + 8] rows, zero except gated (slot D+3),
    energy (D+4) and lag, phase, peak (D+5..D+7)."""
    _build.kernel_limits(cfg)
    if decim.device.type == "cpu":
        return extract_gate_ref(cfg, decim, dprev0, lag, phase, peak)
    dev = decim.device
    N, C, out = _extract_operands(cfg, decim, dprev0, lag, phase, peak)
    ptrs = _build.cuda_args(decim, dprev0, lag, phase, peak, out, device=dev)
    err = _build.load(cfg).sc_extract_gate(
        *ptrs, N, C, int(decim.dtype == torch.bfloat16),
        float(cfg.effective_peak_gate),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "extract_gate")
    _build.LAUNCHES["extract_gate"] += 1
    return out


@functools.lru_cache(maxsize=8)
def _pn(dev) -> torch.Tensor:
    """The PN chips as f32 on ``dev`` (uploaded once per device: a
    per-block streaming loop must not wait on host copies)."""
    return torch.from_numpy(PREAMBLE_VALUES.astype(np.float32)).to(dev)


def _dft_table(cfg: ModemConfig):
    """[P, nfft] f32 real and imaginary planes of the CFO DFT, rounded to
    bf16 values under ``cfg.cfo_dtype="bf16"`` (``decode_pallas.
    _dft_operands``)."""
    wm = dft_matrix(cfg.preamble_length, cfg.cfo_nfft)
    wr = torch.from_numpy(wm.real.copy())
    wi = torch.from_numpy(wm.imag.copy())
    if cfg.cfo_dtype == "bf16":
        return wr.to(torch.bfloat16).float(), wi.to(torch.bfloat16).float()
    return wr, wi


@functools.lru_cache(maxsize=8)
def _decode_tables(cfg: ModemConfig, descramble: bool, dev):
    """(dft_r, dft_i, pn, mask) operands of the decode kernels, uploaded
    once per (config, device); the table's rows padded with zeros to a
    multiple of 4 floats (``csrc/decode.cu`` ``NFFT_LD``: its 16-byte
    copies stay aligned at any size)."""
    pad = -cfg.cfo_nfft % 4
    return (*(torch.nn.functional.pad(t, (0, pad)).to(dev)
              for t in _dft_table(cfg)), _pn(dev),
            torch.from_numpy(_mask_np(cfg.frame_symbols, descramble)).to(dev))


def stat_dict(cfg: ModemConfig, out, *, hunt: bool):
    """The packed [N, D + 8] rows as the JAX launchers' stat dict;
    ``hunt`` adds the lag, phase and peak of the in-kernel hunt."""
    D = cfg.frame_symbols
    dec = {
        "dibits": out[:, :D],
        "matches": out[:, D].to(torch.int32),
        "eq_error": out[:, D + 1],
        "cfo_hz": out[:, D + 2],
        "gated": out[:, D + 3] > 0.5,
        "energy": out[:, D + 4],
    }
    if hunt:
        dec["lag"] = out[:, D + 5].to(torch.int32)
        dec["phase_idx"] = out[:, D + 6].to(torch.int32)
        dec["peak"] = out[:, D + 7]
    return dec


def fused_hunt_decode_decim(cfg: ModemConfig, decim_prev0, decim_cur, *,
                            channels: int, descramble: bool = True,
                            block_channels: int = 64,
                            segs_per_chunk: int = 2, stage: str = "full",
                            interpret: bool = False):
    """Hunt + extraction + decode straight from decimated planes.

    Args:
      decim_prev0: [cycles, 2, channels, n_sym] the carried planes of the
                   block before each channel's first block.
      decim_cur:   [cycles, 2, N, n_sym] the batch's planes, row
                   n = b*channels + ch: row n's previous block is row
                   n - channels, or ``decim_prev0`` row n.

    Returns the :func:`fused_decode` stat dict plus "lag", "phase_idx"
    and "peak".  On the card this is :func:`hunt` then
    :func:`extract_decode`, two kernels launched one after the other;
    ``stage="gate"`` runs :func:`extract_gate` for the second (gated and
    energy are real, the decode's stats zero).  ``block_channels``,
    ``segs_per_chunk`` and ``interpret`` only size the TPU kernel; they
    are accepted and ignored.
    """
    check_stage(stage)
    if decim_prev0.shape[2] != channels:
        raise ValueError(f"decim_prev0 has {decim_prev0.shape[2]} rows, "
                         f"channels={channels}")
    lag, phase, peak = hunt(cfg, decim_cur, decim_prev0)
    if stage == "gate":
        out = extract_gate(cfg, decim_cur, decim_prev0, lag, phase, peak)
    else:
        out = extract_decode(cfg, decim_cur, decim_prev0, lag, phase, peak,
                             descramble=descramble)
    return stat_dict(cfg, out, hunt=True)


def check_stage(stage: str) -> None:
    """Only the production stage and the gate stage are ported."""
    if stage not in ("full", "gate"):
        raise NotImplementedError(
            f"stage={stage!r} is a cost probe of the TPU kernel and has "
            "no counterpart; ROADMAP: not to port (stage probes)")


def _pad_tail(head):
    """[N, D + 5] decode head -> the [N, D + 8] row with the hunt slots
    left zero."""
    return torch.cat([head, head.new_zeros((head.shape[0], 3))], dim=1)


def _check_row_stats(N: int, lag, phase, peak):
    for t, dt in ((lag, torch.int32), (phase, torch.int32), (peak, _F32)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != (N,)):
            raise ValueError(f"expected {dt} [{N}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def fused_decode_extract_ref(cfg: ModemConfig, windows, lag, phase_idx,
                             peak, *, descramble: bool = True):
    """Plain PyTorch version of :func:`fused_decode_extract` (the packed
    [N, D + 8] rows).  Its CFO DFT depends on the device, as
    :func:`extract_decode_ref`'s does.
    """
    N, pkt_len = windows.shape[0], cfg.pkt_window
    rows = torch.arange(N, device=windows.device)
    sel = windows[rows, phase_idx.long()]                   # [N, 2, wp]
    idx = lag.long()[:, None] + torch.arange(pkt_len, device=windows.device)
    pkt = torch.gather(sel, 2, idx[:, None].expand(N, 2, pkt_len))
    mask = torch.from_numpy(_mask_np(cfg.frame_symbols, descramble))
    return _pad_tail(_decode_core(cfg, pkt[:, 0], pkt[:, 1], peak[:, None],
                                  mask.to(windows.device)))


def fused_decode_extract(cfg: ModemConfig, windows, lag, phase_idx, peak,
                         *, descramble: bool = True,
                         block_channels: int = 64,
                         interpret: bool = False):
    """Extract each row's packet from its padded hunt windows and decode.

    Args:
      windows:   [N, cycles, 2, wp] f32 window planes, left-padded by
                 eq_length//2 zeros (a packet at lag l starts at padded
                 index l) and right-padded so that
                 n_sym - 1 + pkt_window <= wp.
      lag, phase_idx: [N] int32; peak: [N] f32.

    Returns the :func:`fused_decode` stat dict.  ``block_channels`` and
    ``interpret`` only size the TPU kernel; accepted and ignored.
    """
    N, wp = windows.shape[0], windows.shape[-1]
    if wp < (cfg.symbols_per_block - 1) + cfg.pkt_window or \
            tuple(windows.shape) != (N, cfg.cycles, 2, wp):
        raise ValueError(f"bad windows shape {tuple(windows.shape)}")
    if windows.dtype != _F32:
        raise TypeError(f"windows must be f32, got {windows.dtype}")
    lag, phase_idx = lag.to(torch.int32), phase_idx.to(torch.int32)
    _check_row_stats(N, lag, phase_idx, peak)
    _build.kernel_limits(cfg)
    if windows.device.type == "cpu":
        out = fused_decode_extract_ref(cfg, windows, lag, phase_idx, peak,
                                       descramble=descramble)
        return stat_dict(cfg, out, hunt=False)
    dev = windows.device
    out = torch.empty((N, cfg.frame_symbols + 8), dtype=_F32, device=dev)
    ptrs = _build.cuda_args(windows, lag, phase_idx, peak,
                            *_decode_tables(cfg, descramble, dev), out,
                            device=dev)
    err = _build.load(cfg).sc_decode_extract(
        *ptrs, N, wp, *_build.decode_params(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_extract")
    _build.LAUNCHES["decode_extract"] += 1
    return stat_dict(cfg, out, hunt=False)


def fused_decode_ref(cfg: ModemConfig, pkt_r, pkt_i, peak, *,
                     descramble: bool = True):
    """Plain PyTorch version of :func:`fused_decode` (the packed
    [N, D + 8] rows).  Its CFO DFT depends on the device, as
    :func:`extract_decode_ref`'s does.
    """
    mask = torch.from_numpy(_mask_np(cfg.frame_symbols, descramble))
    return _pad_tail(_decode_core(cfg, pkt_r, pkt_i, peak[:, None],
                                  mask.to(pkt_r.device)))


def fused_decode(cfg: ModemConfig, pkt_r, pkt_i, peak, *,
                 descramble: bool = True, block_channels: int = 256,
                 interpret: bool = False):
    """Decode extracted packets.

    Args:
      pkt_r/pkt_i: [N, pkt_window] f32 aligned packet planes (first chip
                   at index eq_length//2).
      peak:        [N] f32 hunt correlation peak.

    Returns a dict with dibits (f32 [N, D]), matches, eq_error, cfo_hz,
    gated, energy.  ``block_channels`` and ``interpret`` only size the
    TPU kernel; accepted and ignored.
    """
    N = pkt_r.shape[0]
    for t in (pkt_r, pkt_i):
        if t.dtype != _F32 or tuple(t.shape) != (N, cfg.pkt_window):
            raise ValueError(f"expected f32 [{N}, {cfg.pkt_window}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_row_stats(N, None, None, peak)
    _build.kernel_limits(cfg)
    if pkt_r.device.type == "cpu":
        out = fused_decode_ref(cfg, pkt_r, pkt_i, peak,
                               descramble=descramble)
        return stat_dict(cfg, out, hunt=False)
    dev = pkt_r.device
    out = torch.empty((N, cfg.frame_symbols + 8), dtype=_F32, device=dev)
    ptrs = _build.cuda_args(pkt_r, pkt_i, peak,
                            *_decode_tables(cfg, descramble, dev), out,
                            device=dev)
    err = _build.load(cfg).sc_decode_packets(
        *ptrs, N, *_build.decode_params(cfg),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_packets")
    _build.LAUNCHES["decode_packets"] += 1
    return stat_dict(cfg, out, hunt=False)
