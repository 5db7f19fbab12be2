"""What the redesigned hunt and decode kernels rely on, pinned on the CPU.

No CUDA kernel runs here.  These tests hold, against the port's plain
versions (``ops/decode._hunt_core``) and in numpy:

  * the Toeplitz identity of the hunt: with y[t][s] = sum_k x[off + t +
    k] pn[16 s + k] from ONE pass over t = 0..487, the correlation of
    segment s at lag l is y[l + 16 s][s] -- exactly, in the int8 and the
    bf16 operand mode;
  * the exactness the int32 tensor-core route assumes (|segment sum| <=
    16 * 127, re^2 + im^2 < 2^24) and the one place where it ends: the
    running sum over the 8 segments passes 2^24, so its f32 order is
    output;
  * a lane-by-lane model of ``csrc/hunt.cu``'s int8 body (the fragment
    layout of ``mma.m16n8k16.s8``, the funnel-shifted A words, the
    running sum handed along each quad, the sliding espan sums, the
    tie rules), equal to ``_hunt_core`` to the bit on lag, phase and peak;
    also at 4, 2 and 1 segments, whose 32-, 64- and 128-chip segments
    add their int32 chunk sums inside a quad thread or, past 32 chips,
    hand them along the quad to the thread that squares them;
  * the CFO DFT accumulated in chunks of k in the kernel's order, equal
    to the unchunked loop bit for bit (and not to per-chunk partial sums);
  * the ``extern "C"`` entry points of ``csrc/*.cu`` against
    ``ops/_build._SIGNATURES``, by name, argument count and type.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from singlecarrier_tpu_torch import DEFAULT_CONFIG
from singlecarrier_tpu_torch.constants import PREAMBLE_VALUES
from singlecarrier_tpu_torch.dsp.fftops import dft_matrix
from singlecarrier_tpu_torch.ops import _build, decode

BENCH = DEFAULT_CONFIG.replace(decim_dtype="bf16", hunt_dtype="int8",
                               ls_refit_symbols=128)
CONFIGS = {"int8": BENCH, "bf16": DEFAULT_CONFIG}
OFF, N_SYM, P, NSEG, SEG, CYC = 2, 376, 128, 8, 16, 5
T_ROWS = N_SYM + SEG * (NSEG - 1)          # 488 values of t = l + 16 s


def _windows(cfg, seed, rows=3, scale=1.0):
    """[cyc, 2, rows, wp] f32 hunt windows of seeded planes: noise, and a
    preamble of random phase and delay in the last row."""
    rng = np.random.default_rng(seed)
    dt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    pl = rng.normal(0, 0.5 * scale, (CYC, 2, 2 * rows, N_SYM))
    lag, ph = int(rng.integers(0, N_SYM)), rng.uniform(0, 2 * np.pi)
    pn = PREAMBLE_VALUES.astype(np.float64)
    full = np.concatenate([pl[:, :, rows - 1], pl[:, :, 2 * rows - 1]], -1)
    full[2, 0, lag:lag + P] += 2.0 * np.cos(ph) * pn
    full[2, 1, lag:lag + P] += 2.0 * np.sin(ph) * pn
    pl[:, :, rows - 1], pl[:, :, 2 * rows - 1] = (full[..., :N_SYM],
                                                  full[..., N_SYM:])
    planes = torch.from_numpy(pl.astype(np.float32)).to(dt)
    return decode._windows(cfg, planes[:, :, rows:], planes[:, :, :rows])


def _pn():
    return torch.from_numpy(PREAMBLE_VALUES.astype(np.float32))


@pytest.mark.parametrize("mode", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [3, 11])
def test_one_pass_over_t_gives_every_segment_of_every_lag(mode, seed):
    cfg = CONFIGS[mode]
    x = decode._hunt_operand(cfg, _windows(cfg, seed))
    pn = _pn()
    # y[..., t, s]: ascending k in f32, all 8 segments from x[off+t .. +15]
    y = torch.zeros(x.shape[:-1] + (T_ROWS, NSEG))
    for k in range(SEG):
        xk = x[..., OFF + k:OFF + k + T_ROWS]
        y = y + xk[..., None] * pn.reshape(NSEG, SEG)[:, k]
    lags = torch.arange(N_SYM)
    for s in range(NSEG):
        want = decode._segment_corr(cfg, x, pn, s)
        assert torch.equal(y[..., lags + SEG * s, s], want), (mode, s)


def test_int8_segment_sums_are_exact_and_their_squares_fit_f32():
    cfg = BENCH
    wins = _windows(cfg, 7, scale=40.0)        # most values clip to +/-127
    x = decode._hunt_operand(cfg, wins)
    assert float(x.abs().max()) == 127.0 and torch.equal(x, x.round())
    pn = _pn()
    xi = x.to(torch.int64)
    for s in range(NSEG):
        corr = decode._segment_corr(cfg, x, pn, s)
        exact = torch.zeros(corr.shape, dtype=torch.int64)
        for k in range(SEG):
            st = OFF + s * SEG + k
            exact += xi[..., st:st + N_SYM] * int(pn[s * SEG + k])
        assert torch.equal(corr.to(torch.int64), exact)
        assert int(exact.abs().max()) <= SEG * 127
        sq = exact[:, 0] ** 2 + exact[:, 1] ** 2
        assert int(sq.max()) < 2 ** 24
        p2 = corr * corr
        assert torch.equal((p2[:, 0] + p2[:, 1]).to(torch.int64), sq)


def _adversarial_window():
    """One row whose lag-0 segments correlate to (2031, 2032) each: every
    square-sum is odd and the running sum passes 2^24 at the third."""
    pn = PREAMBLE_VALUES.astype(np.float32)
    wins = np.zeros((CYC, 2, 1, 768), np.float32)
    re = 127.0 * pn
    re[::SEG] = 126.0 * pn[::SEG]              # one chip a segment: 2031
    wins[0, 0, 0, OFF:OFF + P] = re / 16.0
    wins[0, 1, 0, OFF:OFF + P] = 127.0 * pn / 16.0
    return torch.from_numpy(wins)


def test_the_order_of_the_segment_sum_is_output():
    cfg = BENCH
    wins = _adversarial_window()
    lag, ph, peak = decode._hunt_core(cfg, wins)
    assert (int(lag), int(ph)) == (0, 0)
    q = 2031 ** 2 + 2032 ** 2
    assert q % 2 == 1 and q < 2 ** 24 < 3 * q
    asc = np.float32(0)
    for _ in range(NSEG):
        asc = np.float32(asc + np.float32(q))
    exact = NSEG * q
    assert float(asc) != float(exact)          # the f32 running sum rounds
    assert float(np.float32(exact)) != float(asc)
    scale = np.float32(1.0 / cfg.hunt_int8_scale ** 2)
    assert float(peak) == float(np.float32(np.float32(2.0) * asc) * scale)
    assert float(peak) != float(np.float32(2.0 * exact) * scale)


# --------------------------------------- a lane-by-lane model of hunt.cu

def _funnel_r(lo, hi, sh):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(sh)) & np.uint64(0xffffffff)).astype(np.uint32)


def _bytes_s8(w):
    """[..., 4] signed bytes of little-endian words."""
    b = np.stack([(w >> np.uint32(8 * i)) & np.uint32(0xff)
                  for i in range(4)], -1).astype(np.int64)
    return np.where(b > 127, b - 256, b)


def _mma_m16n8k16_s8(a0, a1, b):
    """The four s32 results a lane holds of D = A x B, from the lanes' A
    registers (a0: row g, a1: row g + 8, columns 4 tig..+3) and B register
    (rows 4 tig..+3 of column g), by the PTX fragment layout."""
    lanes = np.arange(32)
    g, tig = lanes >> 2, lanes & 3
    A = np.zeros((16, 16), np.int64)
    B = np.zeros((16, 8), np.int64)
    for i in range(4):
        A[g, 4 * tig + i] = _bytes_s8(a0)[:, i]
        A[g + 8, 4 * tig + i] = _bytes_s8(a1)[:, i]
        B[4 * tig + i, g] = _bytes_s8(b)[:, i]
    D = A @ B
    return np.stack([D[g, 2 * tig], D[g, 2 * tig + 1],
                     D[g + 8, 2 * tig], D[g + 8, 2 * tig + 1]])


def _model_hunt_mma(cfg, win):
    """(lag, phase, peak) of one row's [cyc, 2, wp] f32 windows, computed
    as a warp of ``hunt_mma_kernel`` computes them: segments of 16 chips
    (a chunk), or of 32, 64 or 128 (GRP = 2, 4, 8 chunks: the int32 sums
    of a segment added inside a quad thread, then for GRP 4 and 8 handed
    along the quad with the running sum until the segment's last thread
    squares them)."""
    f32 = np.float32
    grp = P // cfg.corr_segments // 16
    span = grp // 2 if grp > 2 else 1      # quad threads a segment spans
    lanes = np.arange(32)
    g, tig = lanes >> 2, lanes & 3
    w = win[:, :, OFF:OFF + 512].astype(f32)
    xq = np.clip(np.rint(w * f32(cfg.hunt_int8_scale)), -127, 127)
    words = np.ascontiguousarray(xq.astype(np.int8)).view("<u4")  # [5,2,128]
    pn = PREAMBLE_VALUES.astype(np.int8)
    bfrag = np.zeros(32, np.uint32)
    for i in range(4):
        bfrag |= (pn[SEG * g + 4 * tig + i].astype(np.uint8)
                  .astype(np.uint32) << np.uint32(8 * i))
    ssum = np.zeros(512, f32)
    for c in range(CYC):
        ssum = ssum + (w[c, 0] * w[c, 0] + w[c, 1] * w[c, 1])
    NL = 13
    en_s = np.zeros(384, f32)
    for lane in range(29):
        en = np.zeros(NL, f32)
        for j in range(P + NL - 1):
            v = ssum[lane * NL + j]
            lo, hi = max(0, j - P + 1), min(NL - 1, j)
            en[lo:hi + 1] = en[lo:hi + 1] + v
        stop = min(384, lane * NL + NL)
        en_s[lane * NL:stop] = en[:stop - lane * NL]

    best = [np.full(32, -1, f32), np.zeros(32, f32),
            np.zeros(32, np.int64), np.zeros(32, np.int64)]
    wbase, sh = tig + (g >> 2), 8 * (g & 3)
    lag0 = 16 * (tig >> 1) + g + 8 * (tig & 1)
    up = np.maximum(lanes - 1, 0)
    first, last = tig % span == 0, tig % span == span - 1
    for c in range(CYC):
        qe = np.zeros((2, 32), f32)
        p1, p2, fin = qe.copy(), qe.copy(), qe.copy()
        e = np.zeros((2, 2, 32), np.int64)   # even columns: [plane, row]
        j1, j2 = e.copy(), e.copy()          # the segment's int32 sums
        for T in range(31):
            d = []
            for pl in range(2):
                xw = words[c, pl]
                idx = wbase + 4 * T
                d.append(_mma_m16n8k16_s8(
                    _funnel_r(xw[idx], xw[idx + 1], sh),
                    _funnel_r(xw[idx + 2], xw[idx + 3], sh), bfrag))
            r = np.where(tig == 0, f32(0), p2[:, up])
            if grp == 1:
                q = (d[0] ** 2 + d[1] ** 2).astype(f32)    # [4, 32]
                assert int((d[0] ** 2 + d[1] ** 2).max()) < 2 ** 24
                acc = (r + qe) + q[[1, 3]]
                qe = q[[0, 2]]
            else:
                odd = np.stack([d[0][[1, 3]], d[1][[1, 3]]])   # [2, 2, 32]
                got = np.where(first, 0, j2[:, :, up]) if grp > 2 else 0
                seg = got + e + odd
                sq = seg.astype(np.int64) ** 2
                assert int(np.abs(seg).max()) <= 127 * 16 * grp
                if grp == 2:       # squares < 2^24: one rounding of their sum
                    pw_s = (sq[0] + sq[1]).astype(f32)
                    acc = r + pw_s
                else:              # each square rounded, then their sum
                    pw_s = sq[0].astype(f32) + sq[1].astype(f32)
                    acc = np.where(last, r + pw_s, r)
                j2, j1 = j1, seg
                e = np.stack([d[0][[0, 2]], d[1][[0, 2]]])
            p2, p1 = p1, acc
            if T >= 7:
                if (T - 7) % 2 == 0:
                    fin = acc
                else:
                    src = lanes | 3
                    pw = np.select([tig == 0, tig == 1, tig == 2],
                                   [fin[0, src], fin[1, src], acc[0, src]],
                                   acc[1])
                    lag = 16 * (T - 8) + lag0
                    v = pw / (en_s[lag] + f32(1e-12))
                    upd = (lag < N_SYM) & (v > best[0])
                    best = [np.where(upd, new, old) for new, old in
                            zip((v, pw, lag, np.full(32, c)), best)]
    v, pw, lag, c = best
    order = np.lexsort((lag, c, -v.astype(np.float64)))
    k = order[0]
    scale = f32(1.0 / cfg.hunt_int8_scale ** 2)
    return int(lag[k]), int(c[k]), f32(f32(2.0) * pw[k]) * scale


@pytest.mark.parametrize("case", ["noise", "clipped", "adversarial",
                                  "empty"])
def test_lane_model_of_the_mma_hunt_equals_the_plain_hunt(case):
    cfg = BENCH
    if case == "adversarial":
        wins = _adversarial_window()
    elif case == "empty":
        wins = torch.zeros((CYC, 2, 2, 768))
        wins[3, 0, 1, 500] = 0.25              # one sample, many tied lags
    else:
        wins = _windows(cfg, 21, scale=30.0 if case == "clipped" else 1.0)
    lag, ph, peak = decode._hunt_core(cfg, wins)
    for n in range(wins.shape[2]):
        got = _model_hunt_mma(cfg, wins[:, :, n].numpy())
        assert got[:2] == (int(lag[n]), int(ph[n])), (case, n)
        assert float(got[2]) == float(peak[n]), (case, n)


def _long_segment_window(n_seg):
    """One row whose lag-0 segments of P / n_seg chips correlate to (127
    seg - 1, 127 seg): at 64 and 128 chips every square passes 2^24, and
    the odd one is rounded to f32."""
    seg = P // n_seg
    pn = PREAMBLE_VALUES.astype(np.float32)
    wins = np.zeros((CYC, 2, 1, 768), np.float32)
    re = 127.0 * pn
    re[::seg] = 126.0 * pn[::seg]              # one chip a segment
    wins[0, 0, 0, OFF:OFF + P] = re / 16.0
    wins[0, 1, 0, OFF:OFF + P] = 127.0 * pn / 16.0
    return torch.from_numpy(wins)


@pytest.mark.parametrize("case", ["noise", "clipped", "full_scale"])
@pytest.mark.parametrize("n_seg", [4, 2, 1])
def test_lane_model_of_the_mma_hunt_at_long_segments(n_seg, case):
    """Segments of 32, 64 and 128 chips: the model of the int8 body's
    quad epilogue equals the plain hunt to the bit, on noise, on clipped
    windows, and on a full-scale preamble whose segment squares pass
    2^24 at 64 and 128 chips."""
    cfg = BENCH.replace(corr_segments=n_seg)
    if case == "full_scale":
        wins = _long_segment_window(n_seg)
    else:
        wins = _windows(cfg, 23, scale=30.0 if case == "clipped" else 1.0)
    lag, ph, peak = decode._hunt_core(cfg, wins)
    for n in range(wins.shape[2]):
        got = _model_hunt_mma(cfg, wins[:, :, n].numpy())
        assert got[:2] == (int(lag[n]), int(ph[n])), (n_seg, case, n)
        assert float(got[2]) == float(peak[n]), (n_seg, case, n)
    if case == "full_scale":
        assert (int(lag[0]), int(ph[0])) == (0, 0)
        seg = P // n_seg
        assert (float(peak[0]) * cfg.hunt_int8_scale ** 2 / 2
                > n_seg * 2 * (127 * seg - 1) ** 2 * 0.999)
        assert n_seg > 2 or (127 * seg - 1) ** 2 > 2 ** 24


# ------------------------------------------------- the decode's CFO DFT

def _dft_sums(tr, ti, wr, wi, chunk):
    """The kernel's four running sums over k for every (row, bin), k
    walked in chunks of ``chunk`` with the sums carried across them."""
    s1 = torch.zeros((tr.shape[0], wr.shape[1]))
    s2, s3, s4 = s1.clone(), s1.clone(), s1.clone()
    for k0 in range(0, tr.shape[1], chunk):
        tile_r, tile_i = wr[k0:k0 + chunk], wi[k0:k0 + chunk]   # the tile
        for kk in range(tile_r.shape[0]):
            a, b = tr[:, k0 + kk, None], ti[:, k0 + kk, None]
            s1 = s1 + a * tile_r[kk]
            s2 = s2 + b * tile_i[kk]
            s3 = s3 + a * tile_i[kk]
            s4 = s4 + b * tile_r[kk]
    return s1 - s2, s3 + s4


@pytest.mark.parametrize("chunk", [2, 4, 8, 32])   # 2: past 1024 bins
def test_chunked_cfo_dft_equals_the_unchunked_sum_bit_for_bit(chunk):
    rng = np.random.default_rng(chunk)
    tr = torch.from_numpy(rng.normal(0, 1, (6, P)).astype(np.float32))
    ti = torch.from_numpy(rng.normal(0, 1, (6, P)).astype(np.float32))
    wm = dft_matrix(P, 512)
    wr = torch.from_numpy(wm.real.copy())
    wi = torch.from_numpy(wm.imag.copy())
    whole = _dft_sums(tr, ti, wr, wi, P)
    parts = _dft_sums(tr, ti, wr, wi, chunk)
    assert torch.equal(parts[0], whole[0])
    assert torch.equal(parts[1], whole[1])
    # the plain decode's DFT on the card sums in this order
    plain = decode._dft_ascending(tr, ti, wr, wi)
    assert torch.equal(plain[0], parts[0])
    assert torch.equal(plain[1], parts[1])
    # summing each chunk alone and adding the partial sums is another sum
    sr = sum(_dft_sums(tr[:, k:k + chunk], ti[:, k:k + chunk],
                       wr[k:k + chunk], wi[k:k + chunk], chunk)[0]
             for k in range(0, P, chunk))
    assert not torch.equal(sr, whole[0])
    # and both stay close to the plain version's matmul
    want = tr @ wr - ti @ wi
    assert float((whole[0] - want).abs().max()) < 1e-3


# ------------------------------------------------ the C entry points

_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float}


def _extern_c():
    """{name: [ctypes type per argument]} of every ``extern "C" int``
    entry point declared in ``csrc/*.cu``."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             text):
            args = []
            for arg in m.group(2).split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    args.append(ctypes.c_void_p)
                else:
                    args.append(_CTYPE[arg.replace("const ", "").split()[0]])
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = args
    return found


def test_every_entry_point_is_bound_and_every_binding_exists():
    assert sorted(_extern_c()) == sorted(_build._SIGNATURES)
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_entry_point_arguments_match_the_binding(name):
    assert _extern_c()[name] == _build._SIGNATURES[name]


def test_a_variant_build_has_its_own_library_name(tmp_path):
    plain = _build._digest(_build.CSRC, _build.NVCC_FLAGS)
    probe = _build._digest(_build.CSRC,
                           _build.NVCC_FLAGS + ("-DSC_STAGE_CLOCKS",))
    other = tmp_path / "csrc"
    other.mkdir()
    for src in _build.CSRC.iterdir():
        (other / src.name).write_bytes(src.read_bytes())
    assert plain != probe
    assert _build._digest(other, _build.NVCC_FLAGS) == plain
    (other / "hunt.cu").write_text("// another tree\n")
    assert _build._digest(other, _build.NVCC_FLAGS) != plain


def test_using_lends_the_wrappers_a_library_and_takes_it_back(monkeypatch):
    mine, theirs = object(), object()
    monkeypatch.setattr(_build, "_lib", mine)
    with _build.using(theirs) as lib:
        assert lib is theirs and _build.load() is theirs
    assert _build.load() is mine
    with pytest.raises(RuntimeError):
        with _build.using(theirs):
            raise RuntimeError("inside")
    assert _build.load() is mine


def test_the_stage_clocks_are_compiled_only_on_request():
    text = (_build.CSRC / "decode.cu").read_text()
    body = text[text.index("struct StageClock"):]
    assert body.index("#ifdef SC_STAGE_CLOCKS") < body.index("clock64()")
    assert body.index("clock64()") < body.index("#else")
    assert "SC_STAGE_CLOCKS" not in " ".join(_build.NVCC_FLAGS)
