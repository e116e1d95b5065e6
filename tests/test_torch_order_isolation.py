"""Test files that share one process under ``--dist loadfile``.

``tests/test_torch_lockcheck.py`` turns the lock sanitizer on, and every
metric first made in the port's registry meanwhile takes an instrumented
lock. Left so, each later read of the registry records a hold into
``lockcheck.hold_ms``, and two renders of the live registry differ: the
ops plane's ``/metrics`` test failed whenever a worker ran the lockcheck
file first. Here the two files run in that order in one fresh
interpreter, and both must pass.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_the_ops_plane_file_passes_after_the_lockcheck_file_in_one_process():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", "tests/test_torch_lockcheck.py", "tests/test_torch_opsplane.py"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    tail = (r.stdout + r.stderr)[-4000:]
    assert r.returncode == 0, tail
    assert " failed" not in r.stdout.splitlines()[-1], tail
