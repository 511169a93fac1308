"""Race-free first-use build of the port's native C++ libraries.

The four ctypes libraries (native/Makefile) are built from this package's
own ``native/`` directory the first time a process loads them.  Several
processes may do so at once (pytest-xdist workers, a pipeline and its
tests), so ``make`` runs under an exclusive ``fcntl`` lock, and every
Makefile rule links to a temporary name and renames it into place: a
process that opens a library never sees a half-written file.  ``make``
itself is a no-op when a library is newer than its sources, so a stale
library is rebuilt rather than loaded.

``TRUST4_TPU_NATIVE_DIR`` names another directory to build and load the
four libraries from, as the JAX package's loaders take it: a directory
holding the sources and the Makefile (tools/asan_check.py builds the
AddressSanitizer libraries into ``native/asan/`` that way).  The lock is
that directory's own.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "native")
)
NATIVE_DIR_ENV = "TRUST4_TPU_NATIVE_DIR"


def native_dir() -> str:
    """The directory the libraries are built and loaded from:
    ``TRUST4_TPU_NATIVE_DIR`` when set, else the package's ``native/``."""
    return os.path.abspath(os.environ.get(NATIVE_DIR_ENV) or NATIVE_DIR)


def ensure_built(target: str) -> str:
    """Bring ``<native_dir()>/<target>`` up to date under the build lock
    and return its absolute path.  Raises ``OSError`` or
    ``subprocess.CalledProcessError`` when the build cannot run or fails."""
    d = native_dir()
    with open(os.path.join(d, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(
            ["make", "-C", d, target], check=True, capture_output=True,
        )
    return os.path.join(d, target)
