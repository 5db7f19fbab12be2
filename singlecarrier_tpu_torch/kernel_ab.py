"""Hold two builds of the CUDA kernels against each other on one GPU.

Run from the root of a checkout::

    python3 -m singlecarrier_tpu_torch.kernel_ab [--other DIR] [--blocks B]
                                                 [--stages] [--config NAME]
                                                 [--configs NAMES] [--ptxas]

``--other DIR`` names another ``csrc`` tree, for example a parent
commit's (``git archive <commit> singlecarrier_tpu_torch/csrc | tar -x
-C build/parent``).  An older tree whose entry points lack the knob
arguments this tree's take (they stand just before the stream) is called
without them: it runs the default configuration only, which is what is
compared.  Both trees are compiled, and ``frontend_decim``,
``frontend_rows`` (transposed and row-major), their mixer-folded forms
``frontend_decim_folded`` and ``frontend_rows_folded`` (the same
layouts), ``frontend_full``, ``hunt``, ``extract_decode``,
``decode_extract``, ``decode_packets`` and ``extract_gate`` run from
each on the seeded operands of ``tools._measure.kernel_inputs`` (256
channels x 4 blocks and 8192 x 4, golden packets among noise, at
the library default, whose planes are f32, and the bench operating
point, whose planes are bf16).  Reported per kernel: whether the outputs
are equal to the bit; if not, on how many rows, and for the decode
kernels the largest |dcfo| and |deq_error| and whether any valid row's
dibits differ, for the gate stage which of its lag, phase, peak, energy
and gated columns differ.  Then ``frontend_decim`` and
``frontend_decim_folded`` (both ``decim_dtype``s), ``frontend_rows`` and
``frontend_rows_folded`` (their three layouts), ``frontend_full``,
``hunt``, ``extract_decode`` and ``extract_gate`` are timed at 8192
channels x ``--blocks`` blocks of noise in the order this, other, other,
this, and ``frontend_full`` and ``extract_gate`` also at 8192 x 4 rows,
the first beside its FMUL + FADD floor at the SM clock read under it;
last, one dispatch of the main path
``prod_rx_batch(fuse_frontend=True)`` at the bench operating point on
those rows, the same Python around either tree's kernels.

``--stages`` compiles this tree once more with ``-DSC_STAGE_CLOCKS`` and
prints where ``extract_decode`` spends its time: each stage's share of
the warps' ``clock64()`` ticks, and that share of the kernel's time in
the plain build.  It also splits ``frontend_decim``,
``frontend_decim_folded`` and ``frontend_full`` between their staging
(with the stores) and their tap sums, in both trees: a build whose tap
loops form one term of the 49 (``-DSC_FE_TAPS=1``; a one-output tap
loop, which does not know the name, cut in a patched copy of the tree's
``frontend.cu``) is timed beside the whole kernel.

``--knife-edges N`` runs this tree's ``extract_decode`` against its
plain version on N fresh draws of the kernel inputs
(256 channels x 4 blocks, golden packets among noise) at both operating
points and counts the valid rows' dibits that differ, each with its
plain soft margin (distance to the slicer's boundary over the symbol's
magnitude): the evidence for ``tools._measure.KNIFE_EDGE``.

``--ptxas`` (with ``--other``) builds both trees with ``ptxas -v`` and
prints, entry function by entry function, whether the registers, shared
memory and spills it reports are the same (``_build.ptxas_entries``).

``--config NAME`` runs all of it at one of the named numerologies
(``ops/_build.NUMEROLOGIES``) in place of the reference one: both trees
are built with that geometry's defines (``_build.kernel_geometry``), the
operands come from the port's TX at that numerology in place of the
golden stream, and the bench operating point takes ``ls_refit_symbols =
min(128, D)``.  The other tree must compile the geometry from the same
defines (a tree older than them builds the reference shapes and is
refused).  ``--configs NAME,NAME,...`` (``ref`` the reference one, or
``all``) runs the rest at each in turn, after building every geometry's
library of both trees at once, and ends with the count of comparisons
equal to the bit over them all.

Every line carries the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import torch

from . import DEFAULT_CONFIG
from .modem import prod_rx_batch, prod_rx_init_planes
from .ops import _build
from .ops.decode import (extract_decode, extract_gate, fused_decode,
                         fused_decode_extract, hunt)
from .ops.frontend import frontend_decim, frontend_full, frontend_rows
from .ops.fused_rx import _advances
from .tools._measure import (B_CMP, B_KTIME, C_CMP, C_MAIN, KNIFE_EDGE, SEED,
                             bench_point, fp32_floor, hunt_windows,
                             kernel_inputs, numerology_tx, row_inputs,
                             sm_clock_under, time_cuda)
from .tools._measure import card as _card

STAGES = ("extraction", "CFO DFT", "CFO peak", "derotation", "train",
          "refit", "refine", "descramble + output")


def _operands(cfg, gen, tx, C, B, dev):
    """The kernels' operands from the seeded kernel inputs."""
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = kernel_inputs(
        gen, tx, cfg, C, B, dev)
    batch = (pcm, p0r, p0i, t0r, t0i, adv)
    dk = frontend_decim(cfg, *batch)
    rows = row_inputs(cfg, *batch)
    wins, wl, wph, wpk, pkt_r, pkt_i = hunt_windows(
        cfg, frontend_rows(cfg, *rows, transposed=False), C)
    return dict(batch=batch, rows=rows, dk=dk, dprev0=dprev0, wins=wins,
                wl=wl, wph=wph, wpk=wpk, pkt_r=pkt_r, pkt_i=pkt_i)


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
        # gated, energy, lag, phase, peak: the gate stage's real columns
        "extract_gate": extract_gate(cfg, op["dk"], op["dprev0"], lag, ph,
                                     peak)[:, D + 3:],
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
    if name in ("hunt", "extract_gate"):
        cols = (("lag", "phase", "peak") if name == "hunt" else
                ("gated", "energy", "lag", "phase", "peak"))
        return (f"DIFFER on {rows} of {a.shape[0]} rows (" + ", ".join(
            f"{c} {int((a[:, i] != b[:, i]).sum())}"
            for i, c in enumerate(cols)) + ")")
    D = cfg.frame_symbols
    va = (a[:, D + 3] > 0.5) & (a[:, D] > cfg.match_threshold)
    vb = (b[:, D + 3] > 0.5) & (b[:, D] > cfg.match_threshold)
    both = va & vb
    bits = int((a[both, :D] != b[both, :D]).any(1).sum())
    return (f"DIFFER on {rows} of {a.shape[0]} rows: valid flags differ "
            f"on {int((va != vb).sum())}, valid rows with other dibits "
            f"{bits}, max |dcfo| {float((a - b)[:, D + 2].abs().max()):.3e} "
            f"Hz, max |deq_error| {float((a - b)[:, D + 1].abs().max()):.3e}")


def _arity(csrc: Path) -> dict:
    """{entry point: number of arguments} of the ``extern "C"`` functions
    of a ``csrc`` tree."""
    found = {}
    for src in Path(csrc).glob("*.cu"):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             text):
            found[m.group(1)] = len(m.group(2).split(","))
    return found


class _Tree:
    """A library of another ``csrc`` tree behind this tree's entry points.
    Where an entry point of that tree has fewer arguments than this
    tree's, the missing ones are the knob arguments just before the
    stream: a call drops them after checking that they are 0, the
    default configuration, which is all such a tree runs."""

    def __init__(self, lib, csrc: Path):
        self._lib, self._narrow = lib, {}
        for name, n in _arity(csrc).items():
            sig = _build._SIGNATURES.get(name, ())
            if len(sig) > n:
                fn = getattr(lib, name)
                fn.argtypes = sig[:n - 1] + sig[-1:]
                self._narrow[name] = (fn, n - 1, len(sig) - n)

    def __getattr__(self, name):
        if name not in self._narrow:
            return getattr(self._lib, name)
        fn, head, extra = self._narrow[name]

        def call(*args):
            if any(args[head:head + extra]):
                raise ValueError(f"{name}: the other tree runs the default "
                                 f"knobs only")
            return fn(*args[:head], args[-1])
        return call


def _bind_tree(csrc: Path, **build_args):
    """Build and bind ``csrc`` (with ``_build.build``'s other arguments);
    another tree than this one behind this tree's entry points."""
    lib = _build.bind(_build.build(csrc=csrc, **build_args)[0])
    return lib if Path(csrc) == _build.CSRC else _Tree(lib, csrc)


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


def _knife_edges(gen, tx, dev, draws: int, card: str, base,
                 bench) -> None:
    """``extract_decode`` against its plain version on ``draws`` draws of
    the kernel inputs at both operating points (``base`` and
    ``bench``): the valid rows' dibits that differ and their plain soft
    margins."""
    from .ops import decode
    D = base.frame_symbols
    mask = torch.from_numpy(decode._mask_np(D, True)).to(dev)
    valid = near = 0
    margins = []
    for _ in range(draws):
        for cfg in (base, bench):
            pcm, p0r, p0i, t0r, t0i, adv, dprev0 = kernel_inputs(
                gen, tx, cfg, C_CMP, B_CMP, dev)
            dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
            lag, ph, peak = hunt(cfg, dk, dprev0)
            got = extract_decode(cfg, dk, dprev0, lag, ph, peak)
            pkt = decode._extract_from_planes(cfg, dk, dprev0, lag, ph)
            want, ar, ai = decode._decode_core(
                cfg, pkt[:, 0], pkt[:, 1], peak[:, None], mask, soft=True)
            v = ((got[:, D + 3] > 0.5) & (got[:, D] > cfg.match_threshold)
                 & (want[:, D + 3] > 0.5) & (want[:, D] > cfg.match_threshold))
            m = (torch.minimum((ar - ai).abs(), (ar + ai).abs())
                 / torch.sqrt(ar * ar + ai * ai).clamp_min(1e-30))[v]
            valid += int(v.sum())
            near += int((m < KNIFE_EDGE).sum())
            margins += m[(got[v, :D] != want[v, :D])].tolist()
    print(f"[knife] extract_decode of this tree vs plain on {draws} x 2 "
          f"draws of {C_CMP} x {B_CMP} rows: {valid} valid rows, "
          f"{valid * D} valid symbols, {near} of them within "
          f"{KNIFE_EDGE:.0e} of the slicer's boundary; {len(margins)} "
          f"differ, at plain margins {[f'{x:.2e}' for x in margins]}; "
          f"{card}", flush=True)


def _ptxas(other: Path, geo: tuple, card: str) -> None:
    """Print whether ``ptxas -v`` says the same of every entry function
    of this tree and of ``other`` at the geometry ``geo``, and what it
    says of each that moved."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        this, theirs = pool.map(lambda csrc: _build.ptxas_entries(
            _build.build(verbose=True, csrc=csrc, defines=geo)[1]),
            (_build.CSRC, other))
    moved = [k for k in list(theirs) + [k for k in this if k not in theirs]
             if this.get(k) != theirs.get(k)]
    print(f"[ptxas] {len(this)} entry functions in this tree, "
          f"{len(theirs)} in {other}: registers, shared memory and spills "
          f"the same on {len(theirs) - len(moved)}, moved on {len(moved)}; "
          f"{card}", flush=True)
    for k in moved:
        print(f"[ptxas]   {k}: this {this.get(k)}, other {theirs.get(k)}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another csrc tree")
    ap.add_argument("--blocks", type=int, default=128,
                    help="blocks of the timed 8192-channel dispatch")
    ap.add_argument("--stages", action="store_true",
                    help="stage split of extract_decode")
    ap.add_argument("--knife-edges", type=int, default=0, metavar="N",
                    help="the decode's decisions against the plain "
                    "version's on N draws of the kernel inputs")
    ap.add_argument("--config", choices=sorted(_build.NUMEROLOGIES),
                    help="a named numerology in place of the reference one")
    ap.add_argument("--configs", metavar="NAMES",
                    help="comma-separated named numerologies (\"ref\" the "
                    "reference one), or \"all\": the rest at each in turn, "
                    "every geometry of both trees built at once first")
    ap.add_argument("--ptxas", action="store_true",
                    help="with --other: ptxas -v of the two trees, entry "
                    "function by entry function")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card(dev).line
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    if not args.configs:
        return _run(args, root, dev, card)[0]
    names = (["ref", *_build.NUMEROLOGIES] if args.configs == "all"
             else args.configs.split(","))
    unknown = set(names) - {"ref", *_build.NUMEROLOGIES}
    if unknown:
        print(f"kernel_ab: no numerology {sorted(unknown)}", file=sys.stderr)
        return 1
    _prebuild([_build.kernel_geometry(DEFAULT_CONFIG.replace(
        **_build.NUMEROLOGIES.get(name, {}))) for name in names], args.other)
    rc, equal, total = 0, 0, 0
    for name in names:
        args.config = None if name == "ref" else name
        code, e, t = _run(args, root, dev, card)
        rc, equal, total = rc or code, equal + e, total + t
    if args.other:
        print(f"[equal] over {len(names)} numerologies: {equal} of {total} "
              f"comparisons equal to the bit; {card}", flush=True)
    return rc


def _prebuild(geometries: list, other) -> None:
    """Build this tree's (and ``other``'s) library at every geometry,
    eight at a time (each build runs its three nvcc together: more at once
    only adds to the compilers' memory on the card's machine)."""
    jobs = [dict(defines=geo) for geo in geometries] + (
        [dict(csrc=other, defines=geo) for geo in geometries]
        if other else [])
    with concurrent.futures.ThreadPoolExecutor(min(len(jobs), 8)) as pool:
        for fut in [pool.submit(lambda kw: _build.build(**kw), kw)
                    for kw in jobs]:
            fut.result()


def _run(args, root: Path, dev, card: str) -> tuple:
    """Everything at one numerology (``args.config``, or the reference):
    (exit code, comparisons equal to the bit, comparisons)."""
    n_equal = n_compared = 0
    base = DEFAULT_CONFIG.replace(**_build.NUMEROLOGIES.get(args.config, {}))
    geo = _build.kernel_geometry(base)
    bench = bench_point(base)
    if args.other and geo and "SC_N_SAMP" not in (
            Path(args.other) / "common.cuh").read_text():
        print(f"kernel_ab: {args.other} compiles the reference shapes "
              f"only; --config needs a tree that takes the geometry's "
              f"defines", file=sys.stderr)
        return 1, 0, 0
    mine = _build.load(base)
    other = (_bind_tree(args.other, defines=geo) if args.other else None)
    if args.ptxas and other is not None:
        _ptxas(args.other, geo, card)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    if args.config:
        tx = numerology_tx(base, dev)
        card = f"{args.config} numerology; {card}"
    else:
        golden = np.load(root / "tests" / "golden" / "reference.npz")
        tx = torch.from_numpy(golden["tx_pcm"].astype(np.int16)).to(dev)

    if args.knife_edges:
        _knife_edges(gen, tx, dev, args.knife_edges, card, base, bench)

    if other is not None:
        for what, cfg in (("library default", base),
                          ("bench operating point", bench)):
            for C, B in ((C_CMP, B_CMP), (C_MAIN, B_KTIME)):
                op = _operands(cfg, gen, tx, C, B, dev)
                a = _run_all(cfg, op)
                with _build.using(other, base):
                    b = _run_all(cfg, op)
                for name in a:
                    n_equal += bool(torch.equal(a[name], b[name]))
                    n_compared += 1
                    print(f"[equal] {what} ({cfg.decim_dtype} planes), "
                          f"{C} x {B}: {name} of this tree "
                          f"and of {args.other}: "
                          f"{_differences(cfg, name, a[name], b[name])}; "
                          f"{card}", flush=True)
                del op, a, b

    # ---- timing at the full dispatch, on noise ----
    cfg, n = bench, bench.frame_size
    noise = torch.randint(-16384, 16384, (args.blocks, C_MAIN, n),
                          generator=gen, device=dev, dtype=torch.int16)
    p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(cfg, C_MAIN)
    adv = _advances(cfg, args.blocks, dev)[1]
    batch = (noise, p0r, p0i, t0r, t0i, adv)
    rows = row_inputs(cfg, *batch)
    n_small = C_MAIN * B_KTIME
    small = [t[:n_small] for t in rows]
    f32 = cfg.replace(decim_dtype="f32")
    dk = frontend_decim(cfg, *batch)
    lag, ph, peak = hunt(cfg, dk, dprev0)
    dk_s = frontend_decim(cfg, noise[:B_KTIME], p0r, p0i, t0r, t0i,
                          adv[:, :B_KTIME].contiguous())
    lag_s, ph_s, peak_s = hunt(cfg, dk_s, dprev0)
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
                                                      ph, peak),
             "extract_gate": lambda: extract_gate(cfg, dk, dprev0, lag, ph,
                                                  peak),
             f"extract_gate ({n_small} rows)": lambda: extract_gate(
                 cfg, dk_s, dprev0, lag_s, ph_s, peak_s),
             "main path (one dispatch)": lambda: prod_rx_batch(
                 cfg, (p0r, p0i, t0r, t0i, dprev0), noise,
                 fuse_frontend=True)}
    order = [("this", mine)] + ([("other", other), ("other", other),
                                 ("this", mine)] if other else [])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = {}
    for name, fn in calls.items():
        times = []
        for tag, lib in order:
            with _build.using(lib, base):
                times.append((tag, time_cuda(fn, 3)))
        n_rows = n_small if name.endswith("rows)") else rows[0].shape[0]
        note = ""
        if name.startswith("frontend_full"):
            mhz = sm_clock_under(fn)
            floor, what = fp32_floor(cfg, name, n_rows, mhz, sms)
            note = (f"; {what} {floor:.4f} ms at the {mhz:.0f} MHz read "
                    f"under this tree's kernel")
        if name.startswith("main path"):
            note = "; samples/s " + ", ".join(
                f"{tag} {n_rows * n / t * 1e3:.4e}" for tag, t in times)
        print(f"[timing] {name} at {n_rows} rows, ms in the order run: "
              + ", ".join(f"{tag} {t:.3f}" for tag, t in times)
              + f"{note}; {card}", flush=True)
        ms[name] = times[-1][1]                 # this tree's, last run

    if args.stages:
        trees = [("this", mine, _build.CSRC)] + (
            [("other", other, args.other)] if other else [])
        for tag, lib, csrc in trees:
            cut = _one_tap_tree(csrc)          # a copy: bound as a _Tree
            one = _bind_tree(cut["csrc"], defines=cut["defines"] + geo)
            for kern in ("frontend_decim (bf16 planes)",
                         "frontend_decim_folded (bf16 planes)",
                         "frontend_full"):
                with _build.using(lib, base):
                    whole = time_cuda(calls[kern], 3)
                with _build.using(one, base):
                    staged = time_cuda(calls[kern], 3)
                print(f"[stages] {kern} of {tag} tree at "
                      f"{C_MAIN * args.blocks} rows: {whole:.3f} ms "
                      f"whole, {staged:.3f} ms with one term of each tap "
                      f"sum (staging and stores), {whole - staged:.3f} ms "
                      f"the other 48 terms; a kernel that loads the next "
                      f"row during the sums has nothing to hide those "
                      f"loads behind in the one-term build, which then "
                      f"overstates the staging; {card}", flush=True)
        probe = _build.bind(
            _build.build(defines=("SC_STAGE_CLOCKS", *geo))[0])
        ticks = (ctypes.c_uint64 * len(STAGES))()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _build.using(probe, base):
            calls["extract_decode"]()                       # warm-up
            _build.check(probe.sc_decode_stage_cycles(ticks, 1, stream),
                         "stage clocks")
            calls["extract_decode"]()
            _build.check(probe.sc_decode_stage_cycles(ticks, 1, stream),
                         "stage clocks")
        total = float(sum(ticks))
        k3 = ms["extract_decode"]
        print(f"[stages] extract_decode at {C_MAIN * args.blocks} rows, "
              f"{k3:.3f} ms in the plain build; share of the warps' ticks "
              f"and that share of the time: " + ", ".join(
                  f"{s} {t / total:.1%} = {k3 * t / total:.2f} ms"
                  for s, t in zip(STAGES, ticks)) + f"; {card}", flush=True)
    return 0, n_equal, n_compared


if __name__ == "__main__":
    sys.exit(main())
