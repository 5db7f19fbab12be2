"""PyTorch port: the multi-process launcher, two real processes.

Counterpart of ``tests/test_multihost.py``: two OS processes run
``python -m singlecarrier_tpu_torch.parallel.multihost`` on the CPU
(``--device cpu``: gloo), joined through a TCP store on process 0.  Each
feeds its own two of four channels of a real modulated two-packet
stream into the channel-sharded RX and verifies the decoded bits of its
own channels; both must exit 0 and print ``VERIFIED``.
"""

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_decode():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "singlecarrier_tpu_torch.parallel.multihost",
         f"--coordinator=127.0.0.1:{port}", "--num-processes=2",
         f"--process-id={pid}", "--packets=2", "--channels=4",
         "--device=cpu"],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    joined = "\n==== process boundary ====\n".join(o[-2000:] for o in outs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, joined
        assert "VERIFIED" in out, joined
