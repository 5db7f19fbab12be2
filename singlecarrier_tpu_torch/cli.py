"""Command-line interface of the port (``singlecarrier_tpu/cli.py``):
modulate, demodulate, loopback and BER sweeps on raw int16 files, every
numerology constant overridable.  Runs on the card unless ``--device``
says otherwise.

Usage:
  python -m singlecarrier_tpu_torch mod --out tx.raw --packets 10
  python -m singlecarrier_tpu_torch demod --in tx.raw
  python -m singlecarrier_tpu_torch demod --in tx.raw --mode faithful
  python -m singlecarrier_tpu_torch loopback --packets 10
  python -m singlecarrier_tpu_torch ber --snrs 0,2,4,6,8
  python -m singlecarrier_tpu_torch info
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .config import DEFAULT_CONFIG, ModemConfig
from .device import resolve_device


def _add_cfg_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fs", type=float, default=DEFAULT_CONFIG.fs)
    p.add_argument("--rs", type=float, default=DEFAULT_CONFIG.rs)
    p.add_argument("--center", type=float, default=DEFAULT_CONFIG.center)
    p.add_argument("--alpha", type=float, default=DEFAULT_CONFIG.alpha)
    p.add_argument("--ns", type=int, default=DEFAULT_CONFIG.ns)
    p.add_argument("--eq-length", type=int,
                   default=DEFAULT_CONFIG.eq_length)
    p.add_argument("--hunt-dtype", default=DEFAULT_CONFIG.hunt_dtype,
                   choices=["bf16", "f32", "int8"])
    p.add_argument("--decim-dtype", default=DEFAULT_CONFIG.decim_dtype,
                   choices=["f32", "bf16"])
    p.add_argument("--cfo-dtype", default=DEFAULT_CONFIG.cfo_dtype,
                   choices=["f32", "bf16"])
    p.add_argument("--hunt-norm", default=DEFAULT_CONFIG.hunt_norm,
                   choices=["energy", "espan", "none"])
    p.add_argument("--refit-iters", type=int,
                   default=DEFAULT_CONFIG.ls_refit_iters)
    p.add_argument("--refit-symbols", type=int,
                   default=DEFAULT_CONFIG.ls_refit_symbols)
    p.add_argument("--refine-iters", type=int,
                   default=DEFAULT_CONFIG.phase_refine_iters)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions on the host)")


def _cfg_from(args) -> ModemConfig:
    return DEFAULT_CONFIG.replace(
        fs=args.fs, rs=args.rs, center=args.center, alpha=args.alpha,
        ns=args.ns, eq_length=args.eq_length,
        hunt_dtype=args.hunt_dtype, decim_dtype=args.decim_dtype,
        cfo_dtype=args.cfo_dtype, hunt_norm=args.hunt_norm,
        ls_refit_iters=args.refit_iters,
        ls_refit_symbols=args.refit_symbols,
        phase_refine_iters=args.refine_iters)


def _bits(cfg: ModemConfig, packets: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (packets, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)


def _frames(cfg: ModemConfig, pcm: np.ndarray, dtype) -> np.ndarray:
    """The stream zero-padded to whole blocks plus one."""
    n = -(-len(pcm) // cfg.frame_size) + 1
    buf = np.zeros(n * cfg.frame_size, dtype)
    buf[:len(pcm)] = pcm
    return buf.reshape(n, cfg.frame_size)


def _run_rx(cfg: ModemConfig, frames: np.ndarray, dev, descramble: bool):
    """The XLA production RX over [n, frame_size] frames; numpy outputs."""
    from .modem import make_prod_rx_fn, prod_rx_init
    fn = make_prod_rx_fn(cfg, descramble=descramble)
    _, out = fn(prod_rx_init(cfg, device=dev), torch.from_numpy(frames))
    return type(out)(*(v.cpu().numpy() for v in out))


def cmd_info(args) -> int:
    cfg = _cfg_from(args)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({
        "config": {f: getattr(cfg, f) for f in (
            "fs", "rs", "center", "alpha", "ns", "data_symbols",
            "preamble_length", "ntaps", "eq_length")},
        "derived": {
            "cycles": cfg.cycles, "frame_size": cfg.frame_size,
            "bits_per_frame": cfg.bits_per_frame,
            "packet_size": cfg.packet_size,
        },
        "devices": [f"{dev} {name}"],
    }, indent=2))
    return 0


def cmd_mod(args) -> int:
    from .modem import tx_stream

    cfg = _cfg_from(args)
    bits = _bits(cfg, args.packets, args.seed)
    pcm = tx_stream(cfg, bits, scramble=args.scramble,
                    flush_gap=not args.reference_gap,
                    device=args.device).cpu().numpy()
    pcm.astype("<i2").tofile(args.out)
    if args.bits_out:
        np.save(args.bits_out, bits)
    print(f"wrote {len(pcm)} samples ({args.packets} packets) to "
          f"{args.out}", file=sys.stderr)
    return 0


def _demod_faithful(cfg: ModemConfig, frames: np.ndarray, dev,
                    freq_offset: float) -> int:
    """``demod --mode faithful``: the faithful RX over [n, frame_size]
    frames, a JSON line per detected frame."""
    from .modem import make_rx_stream_fn, rx_init
    fn = make_rx_stream_fn(cfg, freq_offset=freq_offset)
    _, out = fn(rx_init(cfg, device=dev), torch.from_numpy(frames))
    out = type(out)(*(v.cpu().numpy() for v in out))
    for fr in np.nonzero(out.valid)[0]:
        print(json.dumps({
            "frame": int(fr),
            "max_index": int(out.max_index[fr]),
            "matches": int(out.matches[fr]),
            "bits": "".join(map(str, out.bits[fr])),
        }))
    print(f"{int(out.valid.sum())} packets detected in {len(frames)} "
          f"blocks", file=sys.stderr)
    return 0


def cmd_demod(args) -> int:
    cfg = _cfg_from(args)
    dev = resolve_device(args.device)
    frames = _frames(cfg, np.fromfile(getattr(args, "in"), dtype="<i2"),
                     np.int16)
    if args.mode == "faithful":
        return _demod_faithful(cfg, frames, dev, args.freq_offset)
    out = _run_rx(cfg, frames, dev, args.descramble)
    for fr in np.nonzero(out.valid)[0]:
        print(json.dumps({
            "frame": int(fr),
            "lag": int(out.lag[fr]),
            "timing_phase": int(out.timing_phase[fr]),
            "matches": int(out.matches[fr]),
            "cfo_hz": round(float(out.cfo_hz[fr]), 2),
            "eq_error": round(float(out.eq_error[fr]), 4),
            "bits": "".join(map(str, out.bits[fr])),
        }))
    print(f"{int(out.valid.sum())} packets detected in {len(frames)} "
          f"blocks", file=sys.stderr)
    return 0


def cmd_loopback(args) -> int:
    from .channel import channel
    from .modem import tx_stream

    cfg = _cfg_from(args)
    dev = resolve_device(args.device)
    bits = _bits(cfg, args.packets, args.seed)
    pcm = tx_stream(cfg, bits, scramble=True, flush_gap=True, device=dev)
    if args.snr is not None or args.cfo:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        pcm = channel(gen, pcm, snr_db=args.snr, freq_hz=args.cfo,
                      fs=cfg.fs, device=dev)
    out = _run_rx(cfg, _frames(cfg, pcm.cpu().numpy(), np.float32), dev,
                  True)
    got = out.bits[out.valid]
    ref = bits.reshape(args.packets, cfg.bits_per_frame)
    k = min(len(got), len(ref))
    ber = float(np.mean(got[:k] != ref[:k])) if k else 1.0
    print(json.dumps({
        "packets_sent": args.packets,
        "packets_detected": int(out.valid.sum()),
        "ber": ber,
        "mean_cfo_hz": float(out.cfo_hz[out.valid].mean()) if k else None,
    }))
    return 0


def cmd_ber(args) -> int:
    from .ber import ber_sweep, qpsk_theory_ber

    cfg = _cfg_from(args)
    snrs = [float(s) for s in args.snrs.split(",")]
    pts = ber_sweep(cfg, snrs, seed=args.seed, device=args.device,
                    n_packets=args.packets, n_trials=args.trials,
                    freq_hz=args.cfo, path=args.path)
    for p in pts:
        p["theory_ber"] = float(qpsk_theory_ber(p["ebn0_db"])[0])
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in p.items()}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="singlecarrier_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print config + device")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("mod", help="modulate packets to a PCM file")
    _add_cfg_flags(p)
    p.add_argument("--out", required=True)
    p.add_argument("--bits-out", default=None)
    p.add_argument("--packets", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scramble", action="store_true")
    p.add_argument("--reference-gap", action="store_true",
                   help="reference-faithful unflushed inter-packet gap")
    p.set_defaults(fn=cmd_mod)

    p = sub.add_parser("demod", help="demodulate a PCM file")
    _add_cfg_flags(p)
    p.add_argument("--in", required=True)
    p.add_argument("--descramble", action="store_true", default=False)
    p.add_argument("--mode", choices=["production", "faithful"],
                   default="production",
                   help="faithful = bit-parity with the C reference")
    p.add_argument("--freq-offset", type=float, default=0.0,
                   help="faithful-mode RX carrier offset (FOFFSET)")
    p.set_defaults(fn=cmd_demod)

    p = sub.add_parser("loopback", help="TX->channel->RX self test")
    _add_cfg_flags(p)
    p.add_argument("--packets", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr", type=float, default=None)
    p.add_argument("--cfo", type=float, default=0.0)
    p.set_defaults(fn=cmd_loopback)

    p = sub.add_parser("ber", help="BER-vs-SNR sweep")
    _add_cfg_flags(p)
    p.add_argument("--snrs", default="0,2,4,6,8,10")
    p.add_argument("--packets", type=int, default=6)
    p.add_argument("--trials", type=int, default=4)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", default="xla",
                   choices=["xla", "batch_pallas", "fused_rx"],
                   help="demod path under test: the XLA path (plain "
                        "PyTorch), the two-kernel batch path, or the "
                        "one-kernel path")
    p.set_defaults(fn=cmd_ber)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
