"""PyTorch port: the kernels' object cache (``ops/_build.build``).

A stand-in ``nvcc`` (a script first on ``PATH``) preprocesses the real
``csrc`` sources with the host's ``cpp`` (empty headers in place of
CUDA's), writes marker objects and libraries, prints a ``ptxas -v`` line
numbered by its call, and logs each call.  So what the build keys an
object on is the sources' own preprocessed text under each geometry's
defines.  No card, no CUDA compiler.
"""

import os
import shutil
import sys

import pytest

from singlecarrier_tpu_torch.config import DEFAULT_CONFIG
from singlecarrier_tpu_torch.ops import _build

STUB_NVCC = """#!{python}
import pathlib, subprocess, sys
args = sys.argv[1:]
if args == ["--version"]:
    sys.exit(print("stand-in nvcc"))
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
    calls = f.tell()
src = next((a for a in args if a.endswith(".cu")), None)
if "-E" in args:
    sys.exit(subprocess.run(
        ["cpp", "-P", "-x", "c++", "-nostdinc", "-I", {headers!r},
         *(a for a in args if a.startswith("-D")), src]).returncode)
out = pathlib.Path(args[args.index("-o") + 1])
if "-shared" in args:
    out.write_bytes(b"library")
else:
    kernel = pathlib.Path(src).stem + "_kernel"
    print(f"ptxas info    : Compiling entry function '{{kernel}}' for "
          f"'sm_90a'")
    print(f"ptxas info    : Used {{calls}} registers, 0 bytes smem")
    out.write_bytes(b"object of " + src.encode())
"""

HEADERS = ("cuda_bf16.h", "cuda_runtime.h", "cuda_pipeline_primitives.h",
           "stdint.h", "type_traits")


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """The stand-in nvcc on PATH, an empty build directory, fresh
    counts; returns the call log's path."""
    if shutil.which("cpp") is None:
        pytest.fail("the host's cpp is needed to preprocess the sources")
    headers = tmp_path / "include"
    headers.mkdir()
    for name in HEADERS:
        (headers / name).write_text("")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, log=str(log),
                                     headers=str(headers)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "OBJECTS", {"compiled": 0, "reused": 0})
    return log


def _compiled(log) -> list:
    """The sources compiled, by stem, in the order logged."""
    return sorted(a.rsplit("/", 1)[-1][:-3]
                  for line in log.read_text().splitlines()
                  if " -c " in f" {line} "
                  for a in line.split() if a.endswith(".cu"))


def _defines(name):
    return _build.kernel_geometry(DEFAULT_CONFIG.replace(
        **_build.NUMEROLOGIES[name]))


def test_geometries_share_the_objects_of_the_sources_they_leave_alone(
        stub_nvcc):
    """Two DFT sizes compile the decode twice and the front-end and the
    hunt once; an equalizer of 7 taps (the hunt's window pad is
    eq_length // 2) then compiles the hunt and the decode; 16 segments the
    hunt and the decode.  Each geometry has its library."""
    a, b = _defines("nfft1001"), _defines("nfft16")
    assert [d for d in a if d not in b] == ["SC_NFFT=1001"]
    libs = {_build.build(defines=a)[0], _build.build(defines=b)[0]}
    assert _compiled(stub_nvcc) == ["decode", "decode", "frontend", "hunt"]
    assert _build.OBJECTS == {"compiled": 4, "reused": 2}
    libs.add(_build.build(defines=_defines("eq7"))[0])
    libs.add(_build.build(defines=_defines("seg16"))[0])
    assert _compiled(stub_nvcc) == ["decode"] * 4 + ["frontend"] + \
        ["hunt"] * 3
    assert _build.OBJECTS == {"compiled": 8, "reused": 4}
    assert len(libs) == 4 and all(p.exists() for p in libs)


def test_a_changed_source_rebuilds_its_object_only(stub_nvcc, tmp_path):
    """A tree whose hunt changes by a comment is a new library of the kept
    objects; a change to its code compiles the hunt alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    geo = _defines("nfft1001")
    first = _build.build(csrc=csrc, defines=geo)[0]
    assert _compiled(stub_nvcc) == ["decode", "frontend", "hunt"]
    hunt = csrc / "hunt.cu"
    hunt.write_text(hunt.read_text() + "// a comment\n")
    second = _build.build(csrc=csrc, defines=geo)[0]
    assert second != first and second.exists()
    assert _compiled(stub_nvcc) == ["decode", "frontend", "hunt"]
    hunt.write_text(hunt.read_text() + "constexpr int kChanged = 1;\n")
    _build.build(csrc=csrc, defines=geo)
    assert _compiled(stub_nvcc) == ["decode", "frontend", "hunt", "hunt"]
    assert _build.OBJECTS == {"compiled": 4, "reused": 5}


def test_a_verbose_build_that_reuses_an_object_returns_its_ptxas_lines(
        stub_nvcc):
    """The second DFT size compiles its decode alone, yet its verbose log
    holds the front-end's and the hunt's ptxas lines as their one compile
    printed them; the library's log is returned again without a call."""
    first = _build.ptxas_entries(
        _build.build(verbose=True, defines=_defines("nfft1001"))[1])
    log = _build.build(verbose=True, defines=_defines("nfft16"))[1]
    second = _build.ptxas_entries(log)
    assert _compiled(stub_nvcc) == ["decode", "decode", "frontend", "hunt"]
    assert sorted(second) == ["decode_kernel", "frontend_kernel",
                              "hunt_kernel"]
    for kern in ("frontend_kernel", "hunt_kernel"):
        assert second[kern] == first[kern] and second[kern]
    assert second["decode_kernel"] != first["decode_kernel"]
    calls = stub_nvcc.read_text()
    assert _build.build(verbose=True, defines=_defines("nfft16"))[1] == log
    assert _build.build(defines=_defines("nfft16"))[1] == ""
    assert stub_nvcc.read_text() == calls
