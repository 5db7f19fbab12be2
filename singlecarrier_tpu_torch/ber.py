"""BER-vs-SNR measurement (``singlecarrier_tpu/ber.py``): synthesize
known payloads, impair, demodulate, count.

Theory anchor: coherent QPSK over AWGN has BER = Q(sqrt(2 Eb/N0)); with
noise over the full fs band at the data sections' power S,
Eb/N0 = SNR fs / (4 rs) (:func:`snr_to_ebn0_db`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .channel import channel
from .config import ModemConfig
from .device import resolve_device, to_int16
from .modem.rx_production import (ProdRxOut, prod_rx_batch, prod_rx_init,
                                  prod_rx_init_planes, prod_rx_stream)
from .modem.tx import tx_stream

PATHS = ("xla", "batch_pallas", "fused_rx")


def qpsk_theory_ber(ebn0_db) -> np.ndarray:
    """Q(sqrt(2 Eb/N0)) for coherent Gray-coded QPSK."""
    ebn0 = 10.0 ** (np.asarray(ebn0_db, np.float64) / 10.0)
    return 0.5 * np.array([math.erfc(math.sqrt(x))
                           for x in np.atleast_1d(ebn0)])


def snr_to_ebn0_db(snr_db, cfg: ModemConfig) -> float:
    """Passband SNR (noise over the full fs band, signal power of the
    data sections) to Eb/N0: N0 = N/(fs/2), Eb = S/(2 rs)."""
    return snr_db + 10.0 * np.log10(cfg.fs / (4.0 * cfg.rs))


def _wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for k errors in n bits."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1.0 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return (max(c - h, 0.0), min(c + h, 1.0))


def data_section_power_mask(cfg: ModemConfig, n_packets: int,
                            n_samples: int) -> np.ndarray:
    """Boolean mask of the full-amplitude data samples of a packed
    ``tx_stream`` layout (packet p's data occupies
    [p*packet_size + preamble_size, p*packet_size + frame_size))."""
    pos = np.arange(n_samples)
    rel = pos % cfg.packet_size
    return ((rel >= cfg.preamble_size) & (rel < cfg.frame_size)
            & (pos < n_packets * cfg.packet_size))


def assign_detections(cfg: ModemConfig, valid, lag, timing_phase,
                      n_packets: int):
    """Match one stream's detections to its sent packets by position.

    ``valid``, ``lag``, ``timing_phase``: [n_blocks] numpy.  The hunt
    window of block b is [prev | cur], so a detection sits at sample
    (b-1)*frame_size + lag*cycles + phase; packet p's preamble starts at
    p*packet_size.  Detections farther than packet_size/4 from every
    packet, and every detection of a packet but its position-closest,
    are false.  Returns ``({packet: (position error, block)},
    false_detects)``.
    """
    assigned: dict[int, tuple[int, int]] = {}
    false_detects = 0
    for fr in np.nonzero(valid)[0]:
        pos = ((int(fr) - 1) * cfg.frame_size
               + int(lag[fr]) * cfg.cycles + int(timing_phase[fr]))
        p = int(round(pos / cfg.packet_size))
        perr = abs(pos - p * cfg.packet_size)
        if not 0 <= p < n_packets or perr > cfg.packet_size // 4:
            false_detects += 1
            continue
        if p not in assigned or perr < assigned[p][0]:
            if p in assigned:
                false_detects += 1
            assigned[p] = (perr, int(fr))
        else:
            false_detects += 1
    return assigned, false_detects


def score_outputs(cfg: ModemConfig, ref, valid, bits, lag, timing_phase, *,
                  snr_db=None, drop_tail_bits: int = 0) -> dict:
    """``ber_run``'s result from RX outputs of [n_trials, n_blocks]
    (numpy; ``bits`` [..., bits_per_frame]) against the sent payloads
    ``ref`` [n_packets, bits_per_frame]: detections matched by stream
    position (:func:`assign_detections`), each undetected packet counted
    as half its bits in error."""
    n_trials, n_packets = valid.shape[0], ref.shape[0]
    sl = slice(None, None if drop_tail_bits == 0 else -drop_tail_bits)
    total_bits = err_bits = detected = false_detects = 0
    for t in range(n_trials):
        assigned, false_t = assign_detections(cfg, valid[t], lag[t],
                                              timing_phase[t], n_packets)
        false_detects += false_t
        detected += len(assigned)
        for p, (_, fr) in assigned.items():
            r = ref[p][sl]
            total_bits += len(r)
            err_bits += int((bits[t, fr][sl] != r).sum())
        missed = n_packets - len(assigned)
        total_bits += missed * len(ref[0][sl])
        err_bits += missed * (len(ref[0][sl]) // 2)
    ci = _wilson_ci(err_bits, total_bits)
    return {
        "ber": err_bits / max(total_bits, 1),
        "err_bits": err_bits,
        "total_bits": total_bits,
        "ber_ci95": [ci[0], ci[1]],
        "detection_rate": detected / (n_trials * n_packets),
        "false_detects": false_detects,
        "snr_db": snr_db,
        "ebn0_db": None if snr_db is None else snr_to_ebn0_db(snr_db, cfg),
    }


def ber_run(cfg: ModemConfig, gen: torch.Generator, *, snr_db=None,
            freq_hz=0.0, phase_rad=0.0, delay=0.0, ppm=0.0, echoes=(),
            n_packets: int = 10, n_trials: int = 4, drop_tail_bits: int = 0,
            path: str = "xla", device=None) -> dict:
    """One sweep point; returns a dict of BER and detection statistics.

    ``gen`` (a ``torch.Generator`` on ``device``) draws the payload bits
    and then every trial's noise: reseeded alike, it gives every path the
    same noisy stream.  The ``n_trials`` channel realizations run as one
    batch: on the XLA path (``prod_rx_stream``, float PCM) or, for
    ``"batch_pallas"`` (two kernels) and ``"fused_rx"`` (the one-kernel
    path), as the channel axis of ``prod_rx_batch`` with the plane state
    and int16 PCM, the code ``bench.py`` times.  ``drop_tail_bits``
    leaves out each packet's last bits (for reference-TX streams whose
    pulse tails are truncated).  On the card unless ``device`` says
    otherwise.
    """
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}")
    dev = resolve_device(device)
    bits = torch.randint(0, 2, (n_packets, cfg.ns, cfg.data_symbols * 2),
                         generator=gen, device=dev, dtype=torch.uint8)
    ref = bits.reshape(n_packets, cfg.bits_per_frame).cpu().numpy()
    pcm = tx_stream(cfg, bits, flush_gap=True, device=dev)

    n_blocks = -(-pcm.shape[-1] // cfg.frame_size) + 1
    padded = torch.zeros(n_blocks * cfg.frame_size, dtype=torch.float32,
                         device=dev)
    padded[:pcm.shape[-1]] = pcm.float()

    # SNR anchored on the data sections' power (the preamble is 6 dB down)
    dmask = torch.from_numpy(data_section_power_mask(
        cfg, n_packets, padded.shape[-1])).to(dev)
    sig_power = float(torch.where(dmask, padded * padded, 0.0).sum()
                      / dmask.sum().clamp(min=1))

    x = channel(gen, padded.expand(n_trials, -1), snr_db=snr_db,
                freq_hz=freq_hz, phase_rad=phase_rad, delay=delay, ppm=ppm,
                echoes=echoes, fs=cfg.fs, signal_power=sig_power,
                device=dev)                                   # [T, S]
    frames = x.reshape(n_trials, n_blocks, cfg.frame_size).transpose(0, 1)
    if path == "xla":
        _, out = prod_rx_stream(cfg, prod_rx_init(cfg, (n_trials,), dev),
                                frames, descramble=False)
    else:
        _, out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, n_trials, dev),
                               to_int16(frames).contiguous(),
                               descramble=False,
                               fuse_frontend=(path == "fused_rx"))
    out = ProdRxOut(*(v.transpose(0, 1).cpu().numpy() for v in out))
    return score_outputs(cfg, ref, out.valid, out.bits, out.lag,
                         out.timing_phase, snr_db=snr_db,
                         drop_tail_bits=drop_tail_bits)


def ber_sweep(cfg: ModemConfig, snrs_db, seed: int = 0, *, device=None,
              **kw) -> list:
    """``ber_run`` at each SNR, point i drawn from a generator seeded
    from ``(seed, i)``; returns the list of result dicts."""
    dev = resolve_device(device)
    out = []
    for i, snr in enumerate(snrs_db):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence([seed, i])
                            .generate_state(1)[0]))
        out.append(ber_run(cfg, gen, snr_db=float(snr), device=dev, **kw))
    return out
