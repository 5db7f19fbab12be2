"""Modem numerology / configuration (the port's own copy).

The reference's compile-time ``#define`` block (reference:
headers/qpsk_internal.h:23-61, headers/fir.h:16-17, headers/kalman.h:26,
headers/scramble.h:16-17) as a validated frozen dataclass whose defaults
are the reference values.  Field for field the ``ModemConfig`` of
``singlecarrier_tpu/config.py`` -- a separate type with the same fields,
defaults and derived properties (``tests/test_torch_interop.py`` holds
the two equal); ``interop.config_from_dict`` builds one from the other's
``dataclasses.asdict``.  Standard library only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModemConfig:
    """Single-carrier QPSK modem numerology.

    Defaults reproduce the reference modem exactly
    (headers/qpsk_internal.h:23-61).
    """

    # Sampling / symbol rates -------------------------------------------------
    fs: float = 8000.0          # sample rate, Hz            (qpsk_internal.h:32)
    rs: float = 1600.0          # symbol rate, baud          (qpsk_internal.h:33)
    center: float = 1100.0      # carrier center, Hz         (qpsk_internal.h:37)

    # Framing -----------------------------------------------------------------
    ns: int = 8                 # data frames per packet     (qpsk_internal.h:39)
    data_symbols: int = 31      # symbols per data frame     (qpsk_internal.h:40)
    preamble_length: int = 128  # BPSK chips                 (qpsk_internal.h:53)

    # RRC matched filter ------------------------------------------------------
    ntaps: int = 49             # FIR taps                   (headers/fir.h:16)
    fir_gain: float = 2.2       # FIR output gain            (headers/fir.h:17)
    alpha: float = 0.35         # roll-off; reference default is the
                                # "narrow" filter (firwide=false, qpsk.c:60)
    rrc_nsym: int = 10          # filter span in symbols     (constants.c:46)

    # Adaptive equalizer / Kalman --------------------------------------------
    eq_length: int = 5          # equalizer taps             (qpsk_internal.h:30)
    kalman_E: float = 0.1       # measurement-error init     (kalman.c:61)
    kalman_q: float = 0.08      # process noise              (kalman.c:62)
    data_eq_error_gain: float = 0.1   # decision-directed error scaling
                                      # (equalizer.c:81)

    # Sync / detection --------------------------------------------------------
    fine_timing_offset: int = 3       # decimation phase     (qpsk_internal.h:23)
    match_threshold_margin: int = 30  # detect if matches > P-30 (qpsk.c:196)
    eof_cost_value: float = 5.0       # hunt-reentry cost    (qpsk_internal.h:28)

    # Production-RX extensions (no reference equivalent) ----------------------
    # What each knob means is kept here; how each default was chosen
    # (detection sweeps, BER decompositions, A/B timings) is recorded in
    # the JAX package's config.py, DETECTION.md and BER.md.
    peak_gate: float = 7.0        # corr peak must exceed gate * window
                                  # energy (the reference's commented-out
                                  # energy gate, qpsk.c:196)
    corr_segments: int = 8        # non-coherent correlation segments
                                  # (CFO-tolerant hunt; 1 = reference's
                                  # coherent correlator)
    cfo_nfft: int = 512           # zero-padded DFT size of the CFO search
                                  # (4x zero-pad of the 128 chips keeps
                                  # the parabolic peak bias small)
    cfo_dtype: str = "f32"        # CFO-search DFT precision
                                  # ("f32" | "bf16"); bf16 is a
                                  # decision-level variant, not
                                  # bit-identical
    nlms_mu: float = 0.5          # production data-phase NLMS step size
    hunt_dtype: str = "bf16"      # correlation-hunt operand precision
                                  # ("bf16" | "f32" | "int8"); peak
                                  # statistic only.  "int8" quantizes the
                                  # hunt windows (the PN chips are +/-1/0,
                                  # exactly int8); its sums are exact.
                                  # bf16 is the default because round()
                                  # makes gate-marginal noise blocks
                                  # knife-edge sensitive to ulp-level
                                  # front-end differences
    hunt_int8_scale: float = 16.0  # int8 hunt quantization step:
                                  # q = clip(round(x*scale), +/-127),
                                  # range +/-7.9 in matched-filter units
    frontend_dtype: str = "bf16"  # matched-filter operand precision of
                                  # the fused front-end ("bf16" | "f32")
    mixer_fold: bool = False      # fold the downmix into complex
                                  # decimation taps: one raw real plane
                                  # through the filter, the mixer applied
                                  # after decimation.  Same operations in
                                  # another order (not bit-identical to
                                  # premix)
    decim_dtype: str = "f32"      # storage of the decimated planes
                                  # between the front-end and the
                                  # hunt+decode kernels ("f32" | "bf16");
                                  # bf16 halves their device-memory
                                  # traffic
    hunt_norm: str = "espan"      # hunt argmax statistic ("espan" |
                                  # "energy" | "none").  "espan" divides
                                  # the segmented correlation power by
                                  # the full-rate span energy shared
                                  # across the decimation phases;
                                  # "energy" by the per-phase window
                                  # energy; "none" keeps the raw power.
                                  # The peak > gate*energy criterion reads
                                  # raw power at the chosen lag either way
    hunt_scheme: str = "lagtile"  # matmul schedule of the JAX package's
                                  # in-kernel hunt ("lagtile" | "chunk");
                                  # identical values, no counterpart on
                                  # the card
    ls_reg: float = 1e-4          # ridge regularization of the LS eq fit
                                  # (center tap; relative to the Gram
                                  # trace)
    ls_offtap_reg: float = 1.0    # extra ridge on the off-center taps of
                                  # the training fit: a shrinkage prior
                                  # toward the pure-delay solution
    ls_offtap_reg_refit: float = 0.1  # off-tap shrinkage of the
                                  # decision-directed refit (weaker: 248
                                  # full-power symbols can afford real
                                  # off-taps)
    ls_gram: str = "sliding"      # Gram assembly of the decode:
                                  # "sliding" = lag products +
                                  # prefix-corrected partial sums;
                                  # "direct" = L(L+1)/2 independent sums.
                                  # Same values up to reassociation
    ls_bvec: str = "reduce"       # train-fit b-vector assembly
                                  # ("reduce" | "matmul"); the matmul
                                  # reassociates the same sums
    phase_refine_iters: int = 3   # guarded decision-directed phase-ramp
                                  # passes (each kept only where the
                                  # decision error drops)
    ls_refit_iters: int = 1       # decision-directed LS refit passes
    ls_refit_symbols: int = 0     # refit window: fit the refit on only
                                  # the first this-many data symbols
                                  # (0 = the full ns*data_symbols
                                  # section)
    frac_timing: bool = False     # sub-sample timing recovery: parabolic
                                  # interpolation of the correlation peak
                                  # + 2-tap fractional-delay blend at
                                  # packet extraction

    # Scrambler ---------------------------------------------------------------
    scramble_seed: int = 0x4A80       # DVB LFSR sync seed   (scramble.h:16)

    # TX levels ---------------------------------------------------------------
    tx_amplitude: float = 16384.0     # data int16 scale     (qpsk.c:317)
    preamble_amplitude: float = 8192.0  # preamble at 50%    (qpsk.c:315)
    inter_packet_gap: int = 903       # zero samples between packets
                                      # (qpsk.c:410-412)

    # ------------------------------------------------------------------ derived
    @property
    def cycles(self) -> int:
        """Oversampling factor FS/RS (qpsk_internal.h:35)."""
        return int(self.fs / self.rs)

    @property
    def ts(self) -> float:
        return 1.0 / self.rs

    @property
    def frame_symbols(self) -> int:
        return self.data_symbols * self.ns

    @property
    def data_size(self) -> int:
        """Samples of data per packet (qpsk_internal.h:45)."""
        return self.data_symbols * self.cycles * self.ns

    @property
    def preamble_size(self) -> int:
        """Samples of preamble per packet (qpsk_internal.h:54)."""
        return self.preamble_length * self.cycles

    @property
    def frame_size(self) -> int:
        """Samples per RX processing block (qpsk_internal.h:48)."""
        return self.preamble_size + self.data_size

    @property
    def bits_per_frame(self) -> int:
        """Payload bits per packet (qpsk_internal.h:51)."""
        return self.data_symbols * 2 * self.ns

    @property
    def symbols_per_block(self) -> int:
        """Decimated symbols per RX block (FRAME_SIZE / CYCLES)."""
        return self.frame_size // self.cycles

    @property
    def match_threshold(self) -> int:
        """Minimum trained-chip sign matches for detect (qpsk.c:196)."""
        return self.preamble_length - self.match_threshold_margin

    @property
    def effective_peak_gate(self) -> float:
        """Segment-normalized detection gate (what the kernels apply).

        The clean-signal correlation peak/energy ratio equals the
        SEGMENT LENGTH P/n_seg (each segment's coherent gain: peak =
        sum_s 2|corr_s|^2 ~ 2*P*seg*a^2 over energy 2*P*a^2), so a
        fixed gate silently couples to ``corr_segments`` -- at
        n_seg=32 (4-chip segments) the clean ratio is 4 and a gate of
        7 rejects every true packet.  Normalized so ``peak_gate``
        keeps its DETECTION.md-calibrated meaning at the default
        16-chip segments: effective = peak_gate * (P/n_seg) / 16.
        Identity at the default numerology (128/8 = 16).
        """
        return self.peak_gate * (
            self.preamble_length / self.corr_segments) / 16.0

    @property
    def packet_size(self) -> int:
        """Total samples per packet incl. inter-packet gap (qpsk.c:380-413)."""
        return self.frame_size + self.inter_packet_gap

    @property
    def fir_halo(self) -> int:
        """Carried FIR state: NTAPS-1 samples (fir.c:30-34)."""
        return self.ntaps - 1

    @property
    def pkt_window(self) -> int:
        """Aligned packet-extraction window (production RX).

        Covers eq left margin + preamble + all data symbols + eq right
        margin = P + D + L - 1 symbols, rounded up for layout.  For a
        preamble at the very last searchable lag the final eq window's
        forward margin is clamped (stale by <= 1 symbol) -- affects
        1/376 of stream positions' last data symbol only.
        """
        need = (self.preamble_length + self.frame_symbols
                + self.eq_length - 1)
        return -(-need // 8) * 8

    def __post_init__(self) -> None:
        if self.fs <= 0 or self.rs <= 0:
            raise ValueError("fs and rs must be positive")
        if self.fs % self.rs != 0:
            raise ValueError(
                f"fs ({self.fs}) must be an integer multiple of rs ({self.rs})"
            )
        if self.ntaps % 2 != 1:
            raise ValueError("ntaps must be odd (linear-phase RRC)")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if self.eq_length < 1:
            raise ValueError("eq_length must be >= 1")
        if self.fine_timing_offset < 0 or self.fine_timing_offset >= self.cycles:
            raise ValueError("fine_timing_offset must be in [0, cycles)")
        if not 0 <= self.scramble_seed < (1 << 15):
            raise ValueError("scramble_seed must fit in 15 bits")
        if self.inter_packet_gap < 0:
            raise ValueError("inter_packet_gap must be >= 0")
        # Production-RX hunt invariants (modem/rx_production.py _hunt):
        # one argmax is taken per block, which is only exhaustive if at
        # most ONE preamble can start within any frame_size span of the
        # stream.  packet_size = frame_size + gap >= frame_size
        # guarantees that for gap >= 0 (asserted above); the preamble
        # must also fit inside the 2-block hunt window at the largest
        # searchable lag, i.e. preamble_length <= symbols_per_block.
        if self.hunt_dtype not in ("bf16", "f32", "int8"):
            raise ValueError(
                f"hunt_dtype must be bf16|f32|int8, got {self.hunt_dtype}")
        if self.frontend_dtype not in ("bf16", "f32"):
            raise ValueError(
                f"frontend_dtype must be bf16|f32, got {self.frontend_dtype}")
        if self.cfo_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"cfo_dtype must be f32|bf16, got {self.cfo_dtype}")
        if self.decim_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"decim_dtype must be f32|bf16, got {self.decim_dtype}")
        if self.hunt_int8_scale <= 0:
            raise ValueError("hunt_int8_scale must be positive")
        if self.ls_gram not in ("direct", "sliding"):
            raise ValueError(
                f"ls_gram must be direct|sliding, got {self.ls_gram}")
        if self.ls_bvec not in ("reduce", "matmul"):
            raise ValueError(
                f"ls_bvec must be reduce|matmul, got {self.ls_bvec}")
        if self.hunt_scheme not in ("chunk", "lagtile"):
            raise ValueError(
                f"hunt_scheme must be chunk|lagtile, got "
                f"{self.hunt_scheme}")
        if self.hunt_norm not in ("energy", "espan", "none"):
            raise ValueError(
                f"hunt_norm must be energy|espan|none, got "
                f"{self.hunt_norm}")
        if not 0 <= self.ls_refit_symbols <= self.frame_symbols:
            raise ValueError(
                f"ls_refit_symbols must be in [0, "
                f"{self.frame_symbols}], got {self.ls_refit_symbols}")
        if self.ls_offtap_reg < 0 or self.ls_offtap_reg_refit < 0:
            raise ValueError("ls_offtap_reg(_refit) must be >= 0")
        if self.preamble_length > self.symbols_per_block:
            raise ValueError(
                f"preamble_length ({self.preamble_length}) must be <= "
                f"symbols_per_block ({self.symbols_per_block}): the "
                "single-peak-per-block hunt cannot contain the preamble "
                "in its 2-block window at the last searchable lag")

    def replace(self, **kw) -> "ModemConfig":
        return dataclasses.replace(self, **kw)


# The reference modem's exact numerology.
DEFAULT_CONFIG = ModemConfig()
