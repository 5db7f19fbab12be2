"""PyTorch port: the decode's CFO peak past 1024 bins (``csrc/decode.cu``
``cfo_dft_block`` and ``cfo_peak``), modelled in numpy thread by thread,
against its peak over stored powers (``decode_packet``'s argmax up to
1024 bins) and the plain decode's (``ops/decode._peak_of``).

Past 1024 bins no power is stored.  Thread t of a block of 8 warps keeps
a running (power, bin) per row and bin slot b over the groups of 512
bins, its bins g * 512 + t + 256 b taken in ascending order with strict
>; the slots, the warp's lanes (a butterfly) and the warps are then
reduced, the larger power winning and the lower bin on a tie.  That is
the first maximum: the bin the stored powers' argmax (lane + 32 q in
ascending q, strict >, the same butterfly) and ``torch.argmax`` give,
on ties and ragged sizes too, and where powers are NaN (a NaN never
wins; a row of NaN keeps bin 0 at -1).  No card, no compiler.
"""

import numpy as np
import pytest
import torch

from singlecarrier_tpu_torch.ops import decode

THREADS, BPT, WARPS = 256, 2, 8      # DEC_THREADS, BPT, DEC_ROWS past 1024


def _take(v, i, w, j):
    """``take_first_max``: (w, j) where w is larger or equal at a lower
    bin (NaN never wins)."""
    t = (w > v) | ((w == v) & (j < i))
    return np.where(t, w, v), np.where(t, j, i)


def _butterfly(v, i):
    """The xor butterfly over the last axis (32 lanes) of ``_take``."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v, i = _take(v, i, v[..., lanes ^ o], i[..., lanes ^ o])
    return v, i


def _running(pw):
    """(bin, power) of each row of ``pw`` [R, nfft] as the running design
    finds them."""
    rows, nfft = pw.shape
    gb = THREADS * BPT
    v = np.full((rows, THREADS, BPT), -1.0, np.float32)
    i = np.zeros((rows, THREADS, BPT), np.int64)
    for g in range(-(-nfft // gb)):
        for b in range(BPT):
            bins = g * gb + np.arange(THREADS) + THREADS * b
            p = pw[:, np.minimum(bins, nfft - 1)]
            take = (bins < nfft) & (p > v[:, :, b])
            v[:, :, b] = np.where(take, p, v[:, :, b])
            i[:, :, b] = np.where(take, bins, i[:, :, b])
    sv, si = v[:, :, 0], i[:, :, 0]
    for b in range(1, BPT):
        sv, si = _take(sv, si, v[:, :, b], i[:, :, b])
    wv, wi = _butterfly(sv.reshape(rows, WARPS, 32),
                        si.reshape(rows, WARPS, 32))
    parts_v = np.full((rows, 32), -1.0, np.float32)   # lanes past WARPS
    parts_i = np.zeros((rows, 32), np.int64)
    parts_v[:, :WARPS], parts_i[:, :WARPS] = wv[:, :, 0], wi[:, :, 0]
    v, i = _butterfly(parts_v, parts_i)
    return i[:, 0], v[:, 0]


def _stored(pw):
    """(bin, power) of each row as ``decode_packet`` finds them in the
    stored powers: lane + 32 q, lanes past the last bin holding none."""
    rows, nfft = pw.shape
    v = np.full((rows, 32), -1.0, np.float32)
    i = np.zeros((rows, 32), np.int64)
    for q in range(-(-nfft // 32)):
        bins = np.arange(32) + 32 * q
        p = pw[:, np.minimum(bins, nfft - 1)]
        take = (bins < nfft) & (p > v)
        v, i = np.where(take, p, v), np.where(take, bins, i)
    v, i = _butterfly(v, i)
    return i[:, 0], v[:, 0]


def _powers(kind, nfft, rows=16, seed=5):
    rng = np.random.default_rng(seed + nfft)
    pw = rng.random((rows, nfft), dtype=np.float32)
    if kind == "ties":          # few levels: the maximum repeats
        pw = np.floor(pw * 4).astype(np.float32)
    elif kind == "nan":         # NaN bins, the peak's among them, and a
        pw[rng.random(pw.shape) < 0.3] = np.nan      # row of NaN only
        pw[0, int(np.nanargmax(pw[0]))] = np.nan
        pw[1] = np.nan
    return pw


@pytest.mark.parametrize("nfft", [1025, 1100, 2048, 8192, 32768])
@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
def test_the_running_first_maximum_is_the_stored_powers_argmax(kind, nfft):
    pw = _powers(kind, nfft)
    got, want = _running(pw), _stored(pw)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if kind == "nan":
        assert got[0][1] == 0 and got[1][1] == -1.0
    else:                       # the plain decode's argmax and power
        kbin, p0, _, _ = decode._peak_of(torch.from_numpy(pw))
        assert np.array_equal(got[0], kbin[:, 0].numpy())
        assert np.array_equal(got[1], p0[:, 0].numpy())


@pytest.mark.parametrize("nfft", [2, 16, 31, 1001])
def test_the_stored_powers_argmax_takes_ragged_sizes(nfft):
    """Up to 1024 bins, at sizes no multiple of 32 (and fewer bins than
    lanes), the lanes past the last bin find nothing: the first maximum,
    as the plain decode's."""
    pw = _powers("ties", nfft)
    kbin, p0, _, _ = decode._peak_of(torch.from_numpy(pw))
    got = _stored(pw)
    assert np.array_equal(got[0], kbin[:, 0].numpy())
    assert np.array_equal(got[1], p0[:, 0].numpy())


def test_the_peak_s_neighbours_wrap_and_the_chunked_search_keeps_its_bits():
    """``_peak_ascending`` (the plain decode's search on the card, on the
    rows the energy gate passes, in chunks of rows) equals ``_peak_of``
    the whole powers to the bit on those rows and leaves zeros on the
    others, the neighbours wrapping mod nfft."""
    rng = np.random.default_rng(1)
    nfft, rows = 2049, 9
    tr, ti = (torch.from_numpy(rng.standard_normal((rows, 128),
                                                   dtype=np.float32))
              for _ in range(2))
    wr, wi = (torch.from_numpy(rng.standard_normal((128, nfft),
                                                   dtype=np.float32))
              for _ in range(2))
    sr, si = decode._dft_ascending(tr, ti, wr, wi)
    want = decode._peak_of(sr * sr + si * si)
    keep = torch.tensor([[True], [False], [True], [True], [False],
                         [True], [True], [False], [True]])
    chunk = decode._DFT_CHUNK
    try:
        decode._DFT_CHUNK = 2 * nfft            # two rows a chunk
        got = decode._peak_ascending(tr, ti, wr, wi, keep)
    finally:
        decode._DFT_CHUNK = chunk
    k = keep[:, 0]
    for a, b in zip(got, want):
        assert torch.equal(a[k], b[k]) and not a[~k].any()
    pw = torch.zeros((1, 8))
    pw[0, 0] = 1.0
    pw[0, 7], pw[0, 1] = 0.25, 0.5
    k, p0, pm, pp = decode._peak_of(pw)
    assert (int(k), float(p0), float(pm), float(pp)) == (0, 1.0, 0.25, 0.5)
