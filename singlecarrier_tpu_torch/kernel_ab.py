"""Hold two builds of the CUDA kernels against each other on one GPU.

Run from the root of a checkout::

    python3 -m singlecarrier_tpu_torch.kernel_ab [--other DIR] [--blocks B]
                                                 [--stages]

``--other DIR`` names another ``csrc`` tree, for example a parent
commit's (``git archive <commit> singlecarrier_tpu_torch/csrc | tar -x
-C build/parent``).  Both trees are compiled, and ``frontend_decim``,
``frontend_rows`` (transposed and row-major), their mixer-folded forms
``frontend_decim_folded`` and ``frontend_rows_folded`` (the same
layouts), ``frontend_full``, ``hunt``, ``extract_decode``,
``decode_extract`` and ``decode_packets`` run from each on
``chip_smoke.py``'s seeded operands (256 channels x 4 blocks and 8192
x 4, golden packets among noise, at
the library default, whose planes are f32, and the bench operating
point, whose planes are bf16).  Reported per kernel: whether the outputs
are equal to the bit; if not, on how many rows, and for the decode
kernels the largest |dcfo| and |deq_error| and whether any valid row's
dibits differ.  Then ``frontend_decim`` and ``frontend_decim_folded``
(both ``decim_dtype``s), ``frontend_rows`` and ``frontend_rows_folded``
(their three layouts), ``frontend_full``, ``hunt`` and
``extract_decode`` are timed at 8192 channels x ``--blocks`` blocks of
noise in the order this, other, other, this, and ``frontend_full`` also
at 8192 x 4 rows, beside its FMUL + FADD floor at the SM clock read
under it.

``--stages`` compiles this tree once more with ``-DSC_STAGE_CLOCKS`` and
prints where ``extract_decode`` spends its time: each stage's share of
the warps' ``clock64()`` ticks, and that share of the kernel's time in
the plain build.  It also splits ``frontend_decim``,
``frontend_decim_folded`` and ``frontend_full`` between their staging
(with the stores) and their tap sums, in both trees: a build whose tap
loops form one term of the 49 (``-DSC_FE_TAPS=1``; a one-output tap
loop, which does not know the name, cut in a patched copy of the tree's
``frontend.cu``) is timed beside the whole kernel.

Every line carries the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import DEFAULT_CONFIG
from .modem import prod_rx_init_planes
from .modem.rx_production import _extract_packet_planes
from .ops import _build
from .ops.decode import (extract_decode, fused_decode, fused_decode_extract,
                         hunt)
from .ops.frontend import frontend_decim, frontend_full, frontend_rows

STAGES = ("extraction", "CFO DFT", "CFO peak", "derotation", "train",
          "refit", "refine", "descramble + output")


def _operands(cs, cfg, gen, tx, C, B, dev):
    """The kernels' operands from ``chip_smoke``'s seeded inputs."""
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = cs._kernel_inputs(
        torch, np, gen, tx, cfg, C, B, dev)
    batch = (pcm, p0r, p0i, t0r, t0i, adv)
    dk = frontend_decim(cfg, *batch)
    rows = cs._row_inputs(torch, cfg, *batch)
    drow = frontend_rows(cfg, *rows, transposed=False)
    wins, wl, wph, wpk = cs._hunt_windows(torch, cfg, drow, C)
    off = cfg.eq_length // 2
    pkt = _extract_packet_planes(
        cfg, wins[..., off:off + 2 * drow.shape[-1]].contiguous(), wl, wph)
    return dict(batch=batch, rows=rows, dk=dk, dprev0=dprev0, wins=wins,
                wl=wl, wph=wph, wpk=wpk, pkt_r=pkt[:, 0].contiguous(),
                pkt_i=pkt[:, 1].contiguous())


def _run_all(cfg, op):
    """{kernel: packed rows} from whichever library is in use."""
    D = cfg.frame_symbols
    lag, ph, peak = hunt(cfg, op["dk"], op["dprev0"])

    def rows(dec):
        return torch.cat([dec["dibits"], dec["matches"].float()[:, None],
                          dec["eq_error"][:, None], dec["cfo_hz"][:, None],
                          dec["gated"].float()[:, None],
                          dec["energy"][:, None]], dim=1)

    def by_row(planes):                       # [cyc, 2, N, n_sym] -> [N, .]
        return planes.permute(2, 0, 1, 3).reshape(planes.shape[2], -1)

    out = {
        "frontend_decim": by_row(frontend_decim(cfg, *op["batch"])),
        "frontend_rows (transposed)": by_row(
            frontend_rows(cfg, *op["rows"], transposed=True)),
        "frontend_rows (row-major)": frontend_rows(
            cfg, *op["rows"], transposed=False).flatten(1),
        "frontend_decim_folded": by_row(frontend_decim(
            cfg, *op["batch"], mixer_fold=True)),
        "frontend_rows_folded (transposed)": by_row(frontend_rows(
            cfg, *op["rows"], transposed=True, mixer_fold=True)),
        "frontend_rows_folded (row-major)": frontend_rows(
            cfg, *op["rows"], transposed=False, mixer_fold=True).flatten(1),
        "frontend_full": frontend_full(cfg, *op["rows"]).flatten(1),
        "hunt": torch.stack([lag.float(), ph.float(), peak], 1),
        "extract_decode": extract_decode(cfg, op["dk"], op["dprev0"], lag,
                                         ph, peak)[:, :D + 5],
        "decode_extract": rows(fused_decode_extract(
            cfg, op["wins"], op["wl"], op["wph"], op["wpk"])),
        "decode_packets": rows(fused_decode(cfg, op["pkt_r"], op["pkt_i"],
                                            op["wpk"])),
    }
    torch.cuda.synchronize()
    return out


def _differences(cfg, name, a, b) -> str:
    if torch.equal(a, b):
        return f"equal to the bit on all {a.shape[0]} rows"
    rows = int((a != b).any(1).sum())
    if name.startswith("frontend"):
        return (f"DIFFER on {rows} of {a.shape[0]} rows, "
                f"{int((a != b).sum())} of {a.numel()} plane values, max "
                f"|difference| {float((a.float() - b.float()).abs().max()):.3e}")
    if name == "hunt":
        return (f"DIFFER on {rows} of {a.shape[0]} rows (lag "
                f"{int((a[:, 0] != b[:, 0]).sum())}, phase "
                f"{int((a[:, 1] != b[:, 1]).sum())}, peak "
                f"{int((a[:, 2] != b[:, 2]).sum())})")
    D = cfg.frame_symbols
    va = (a[:, D + 3] > 0.5) & (a[:, D] > cfg.match_threshold)
    vb = (b[:, D + 3] > 0.5) & (b[:, D] > cfg.match_threshold)
    both = va & vb
    bits = int((a[both, :D] != b[both, :D]).any(1).sum())
    return (f"DIFFER on {rows} of {a.shape[0]} rows: valid flags differ "
            f"on {int((va != vb).sum())}, valid rows with other dibits "
            f"{bits}, max |dcfo| {float((a - b)[:, D + 2].abs().max()):.3e} "
            f"Hz, max |deq_error| {float((a - b)[:, D + 1].abs().max()):.3e}")


def _one_tap_tree(csrc: Path) -> dict:
    """Arguments of ``_build.build`` for ``csrc`` with the front-ends' tap
    loops cut to one term: ``-DSC_FE_TAPS=1`` for a loop that knows the
    name, and a copy of the tree in which every one-output tap loop
    (``for (int k = 0; k < NTAPS; ++k)``, an older tree's) runs once."""
    csrc = Path(csrc)
    text = (csrc / "frontend.cu").read_text()
    loop = "for (int k = 0; k < NTAPS; ++k)"
    if "SC_FE_TAPS" not in text and loop not in text:
        raise RuntimeError(f"{csrc}/frontend.cu: no tap loop to cut")
    copy = _build.BUILD_DIR / f"one_tap_{_build._digest(csrc, ())}"
    copy.mkdir(parents=True, exist_ok=True)
    for src in csrc.iterdir():
        (copy / src.name).write_bytes(src.read_bytes())
    (copy / "frontend.cu").write_text(
        text.replace(loop, "for (int k = 0; k < 1; ++k)"))
    return dict(csrc=copy, defines=("SC_FE_TAPS=1",))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another csrc tree")
    ap.add_argument("--blocks", type=int, default=128,
                    help="blocks of the timed 8192-channel dispatch")
    ap.add_argument("--stages", action="store_true",
                    help="stage split of extract_decode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    print(f"[device] {card}; torch {torch.__version__}", flush=True)

    mine = _build.load()
    other = _build.bind(_build.build(csrc=args.other)[0]) if args.other \
        else None
    golden = np.load(root / "tests" / "golden" / "reference.npz")
    tx = torch.from_numpy(golden["tx_pcm"].astype(np.int16)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    bench = DEFAULT_CONFIG.replace(decim_dtype="bf16", hunt_dtype="int8",
                                   ls_refit_symbols=128)

    if other is not None:
        for what, cfg in (("library default", DEFAULT_CONFIG),
                          ("bench operating point", bench)):
            for C, B in ((cs.C_CMP, cs.B_CMP), (cs.C_MAIN, cs.B_KTIME)):
                op = _operands(cs, cfg, gen, tx, C, B, dev)
                a = _run_all(cfg, op)
                with _build.using(other):
                    b = _run_all(cfg, op)
                for name in a:
                    print(f"[equal] {what} ({cfg.decim_dtype} planes), "
                          f"{C} x {B}: {name} of this tree "
                          f"and of {args.other}: "
                          f"{_differences(cfg, name, a[name], b[name])}; "
                          f"{card}", flush=True)
                del op, a, b

    # ---- timing at the full dispatch, on noise ----
    cfg, n = bench, bench.frame_size
    noise = torch.randint(-16384, 16384, (args.blocks, cs.C_MAIN, n),
                          generator=gen, device=dev, dtype=torch.int16)
    p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(cfg, cs.C_MAIN)
    advs = np.exp(-2j * np.pi * cfg.center / cfg.fs * n
                  * np.arange(args.blocks)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag])).to(dev)
    batch = (noise, p0r, p0i, t0r, t0i, adv)
    rows = cs._row_inputs(torch, cfg, *batch)
    n_small = cs.C_MAIN * cs.B_KTIME
    small = [t[:n_small] for t in rows]
    f32 = cfg.replace(decim_dtype="f32")
    dk = frontend_decim(cfg, *batch)
    lag, ph, peak = hunt(cfg, dk, dprev0)
    calls = {"frontend_decim (bf16 planes)":
             lambda: frontend_decim(cfg, *batch),
             "frontend_decim (f32 planes)":
             lambda: frontend_decim(f32, *batch),
             "frontend_rows (transposed bf16)":
             lambda: frontend_rows(cfg, *rows, transposed=True),
             "frontend_rows (transposed f32)":
             lambda: frontend_rows(f32, *rows, transposed=True),
             "frontend_rows (row-major f32)":
             lambda: frontend_rows(cfg, *rows, transposed=False),
             "frontend_decim_folded (bf16 planes)":
             lambda: frontend_decim(cfg, *batch, mixer_fold=True),
             "frontend_decim_folded (f32 planes)":
             lambda: frontend_decim(f32, *batch, mixer_fold=True),
             "frontend_rows_folded (transposed bf16)":
             lambda: frontend_rows(cfg, *rows, transposed=True,
                                   mixer_fold=True),
             "frontend_rows_folded (transposed f32)":
             lambda: frontend_rows(f32, *rows, transposed=True,
                                   mixer_fold=True),
             "frontend_rows_folded (row-major f32)":
             lambda: frontend_rows(cfg, *rows, transposed=False,
                                   mixer_fold=True),
             "frontend_full": lambda: frontend_full(cfg, *rows),
             f"frontend_full ({n_small} rows)":
             lambda: frontend_full(cfg, *small),
             "hunt": lambda: hunt(cfg, dk, dprev0),
             "extract_decode": lambda: extract_decode(cfg, dk, dprev0, lag,
                                                      ph, peak)}
    order = [("this", mine)] + ([("other", other), ("other", other),
                                 ("this", mine)] if other else [])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = {}
    for name, fn in calls.items():
        times = []
        for tag, lib in order:
            with _build.using(lib):
                times.append((tag, cs._time_cuda(fn, 3)))
        n_rows = n_small if name.endswith("rows)") else rows[0].shape[0]
        note = ""
        if name.startswith("frontend_full"):
            mhz = cs._sm_clock_under(torch, fn)
            floor, what = cs._fp32_floor(cfg, name, n_rows, mhz, sms)
            note = (f"; {what} {floor:.4f} ms at the {mhz:.0f} MHz read "
                    f"under this tree's kernel")
        print(f"[timing] {name} at {n_rows} rows, ms in the order run: "
              + ", ".join(f"{tag} {t:.3f}" for tag, t in times)
              + f"{note}; {card}", flush=True)
        ms[name] = times[-1][1]                 # this tree's, last run

    if args.stages:
        trees = [("this", mine, _build.CSRC)] + (
            [("other", other, args.other)] if other else [])
        for tag, lib, csrc in trees:
            one = _build.bind(_build.build(**_one_tap_tree(csrc))[0])
            for kern in ("frontend_decim (bf16 planes)",
                         "frontend_decim_folded (bf16 planes)",
                         "frontend_full"):
                with _build.using(lib):
                    whole = cs._time_cuda(calls[kern], 3)
                with _build.using(one):
                    staged = cs._time_cuda(calls[kern], 3)
                print(f"[stages] {kern} of {tag} tree at "
                      f"{cs.C_MAIN * args.blocks} rows: {whole:.3f} ms "
                      f"whole, {staged:.3f} ms with one term of each tap "
                      f"sum (staging and stores), {whole - staged:.3f} ms "
                      f"the other 48 terms; a kernel that loads the next "
                      f"row during the sums has nothing to hide those "
                      f"loads behind in the one-term build, which then "
                      f"overstates the staging; {card}", flush=True)
        probe = _build.bind(_build.build(defines=("SC_STAGE_CLOCKS",))[0])
        ticks = (ctypes.c_uint64 * len(STAGES))()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _build.using(probe):
            calls["extract_decode"]()                       # warm-up
            _build.check(probe.sc_decode_stage_cycles(ticks, 1, stream),
                         "stage clocks")
            calls["extract_decode"]()
            _build.check(probe.sc_decode_stage_cycles(ticks, 1, stream),
                         "stage clocks")
        total = float(sum(ticks))
        k3 = ms["extract_decode"]
        print(f"[stages] extract_decode at {cs.C_MAIN * args.blocks} rows, "
              f"{k3:.3f} ms in the plain build; share of the warps' ticks "
              f"and that share of the time: " + ", ".join(
                  f"{s} {t / total:.1%} = {k3 * t / total:.2f} ms"
                  for s, t in zip(STAGES, ticks)) + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
