"""PyTorch port: two threads that build or load one kernel geometry at
once (``ops/_build.build`` / ``load``).

A stand-in ``nvcc`` (a script first on ``PATH``) writes its ``-o``
target after a short sleep, logs each call, and fails a link whose
object files are missing: so two builds that share temporary files, or
two builds of one library where one should wait for the other, show.
Its ``-E`` prints its arguments (the object's key) and ``--version`` a
line.  Numpy and torch only; no card, no compiler.
"""

import os
import re
import sys
import threading

import pytest

from singlecarrier_tpu_torch.config import DEFAULT_CONFIG
from singlecarrier_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import pathlib, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    sys.exit(print("stand-in nvcc"))
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if "-E" in args:
    sys.exit(print(" ".join(args)))
out = pathlib.Path(args[args.index("-o") + 1])
if "-shared" in args:
    missing = [a for a in args if a.endswith(".o")
               and not pathlib.Path(a).exists()]
    if missing:
        sys.exit("missing objects: " + " ".join(missing))
time.sleep(0.3)
out.write_bytes(b"fake library" if "-shared" in args else b"fake object")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc on PATH, an empty build directory, no library
    cache; returns the call log's path."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    return log


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


def _compiles(log):
    """The compile and link calls of the log (not the preprocessing)."""
    return [c for c in _calls(log) if "-E" not in c.split()]


def _in_threads(fn, n=2):
    """``fn()`` in ``n`` threads started together; their results."""
    start = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(i):
        start.wait()
        try:
            results[i] = fn()
        except Exception as e:          # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_two_threads_build_one_geometry_once(fake_nvcc):
    """Both get the one library, and nvcc runs for one build: its three
    sources and one link."""
    defines = _build.kernel_geometry(DEFAULT_CONFIG.replace(
        **_build.NUMEROLOGIES["alt_9600"]))
    paths = [p for p, _ in _in_threads(
        lambda: _build.build(defines=defines))]
    assert paths[0] == paths[1] and paths[0].exists()
    calls = _compiles(fake_nvcc)
    assert len(calls) == len(_build.SOURCES) + 1
    assert sum("-shared" in c for c in calls) == 1
    # no temporary file left: the library, its log and the objects
    assert sorted(p.name for p in paths[0].parent.iterdir()) \
        == sorted([paths[0].name, paths[0].with_suffix(".log").name, "obj"])
    objs = sorted(p.name for p in (paths[0].parent / "obj").iterdir())
    assert len(objs) == 2 * len(_build.SOURCES)
    assert all(re.fullmatch(r"(frontend|hunt|decode)_[0-9a-f]{16}\.(o|log)",
                            name) for name in objs), objs


def test_two_threads_load_one_geometry_once(fake_nvcc, monkeypatch):
    """``load(cfg)`` from two threads at a new geometry: one build, one
    bind, the same library in both."""
    bound = []

    def fake_bind(path):
        bound.append(path)
        return ("lib", path)

    monkeypatch.setattr(_build, "bind", fake_bind)
    cfg = DEFAULT_CONFIG.replace(**_build.NUMEROLOGIES["eq7"])
    libs = _in_threads(lambda: _build.load(cfg), n=4)
    assert all(lib == libs[0] for lib in libs) and len(bound) == 1
    assert len(_compiles(fake_nvcc)) == len(_build.SOURCES) + 1
    assert _build.load(cfg) is libs[0]      # cached, no new build
    assert len(_compiles(fake_nvcc)) == len(_build.SOURCES) + 1
