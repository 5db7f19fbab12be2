"""Root-raised-cosine (root-Nyquist) filter design (the port's own copy
of ``singlecarrier_tpu/filter_design.py``; numpy only).

Offline tap generation, re-implemented from the reference's Octave tool
(reference: octave/gen_rn_coeffs.m:7-40).  The reference pasted the
Octave output into C tables (src/constants.c:49-156); here the taps are
generated at config-build time and golden-compared against those tables
in tests/test_filter_design.py.

The algorithm (gen_rn_coeffs.m:15-39): build the time-domain
raised-cosine impulse (sinc x cos/(1-(2 alpha t/Ts)^2) with 0/0
patches), FFT to 4096 bins, suppress the stop band (x0.001 where
|H| < 0.02 -- a hack that keeps sqrt() from amplifying it), take
sqrt(|H|) e^{j angle H}, and IFFT back to real taps.
"""

from __future__ import annotations

import numpy as np


def gen_rn_coeffs(
    alpha: float,
    t: float,
    rs: float,
    nsym: int,
    m: int,
    *,
    nfft: int = 4096,
) -> np.ndarray:
    """Generate root-raised-cosine taps.

    Mirrors ``gen_rn_coeffs(alpha, T, Rs, Nsym, M)``
    (octave/gen_rn_coeffs.m:7).  Returns ``nsym * m`` float64 taps.
    """
    ts = 1.0 / rs

    # n = -Nsym*Ts/2 : T : Nsym*Ts/2  (inclusive range, gen_rn_coeffs.m:11)
    num_pts = int(round(nsym * ts / t)) + 1
    n = (np.arange(num_pts) - (num_pts - 1) / 2.0) * t
    nfilter = nsym * m

    # Raised-cosine impulse response with 0/0 patches (.m:15-26).
    x = np.pi * n / ts
    sinc_den = x
    sinc_op = np.ones_like(n)
    nonzero = np.abs(sinc_den) >= 1e-10
    sinc_op[nonzero] = np.sin(x[nonzero]) / sinc_den[nonzero]

    cos_num = np.cos(alpha * x)
    cos_den = 1.0 - (2.0 * alpha * n / ts) ** 2
    cos_op = np.full_like(n, np.pi / 4.0)
    nonzero = np.abs(cos_den) >= 1e-10
    cos_op[nonzero] = cos_num[nonzero] / cos_den[nonzero]

    gt = sinc_op * cos_op

    # Frequency-domain square root with stop-band suppression (.m:27-37).
    gf = np.fft.fft(gt, nfft) / m
    small = np.abs(gf) < 0.02
    gf[small] *= 0.001
    gf_root = np.sqrt(np.abs(gf)) * np.exp(1j * np.angle(gf))

    # Back to time domain; first Nfilter real taps (.m:38-39).
    return np.real(np.fft.ifft(gf_root))[:nfilter]


def reference_taps(alpha: float, cfg_ntaps: int = 49, *, fs: float = 8000.0,
                   rs: float = 1600.0, nsym: int = 10, m: int = 5) -> np.ndarray:
    """The taps as the reference C tables use them.

    The reference ran ``gen_rn_coeffs(alpha, 1/8000, 1600, 10, 5)``
    (recorded at src/constants.c:46, 103) which yields 50 taps; the C
    tables (src/constants.c:49-99, 106-156) keep taps 1..49 (0-based),
    dropping the first so the 49-tap filter is symmetric.  Verified to
    <5e-9 against both C tables in tests/test_filter_design.py.
    """
    full = gen_rn_coeffs(alpha, 1.0 / fs, rs, nsym, m)
    return full[1:1 + cfg_ntaps]
