"""TRUST4_TPU_NATIVE_DIR in the port (utils/nativebuild.py), as the JAX
package's loaders take it: the four native libraries are built and
loaded from the named directory, under that directory's lock; without
the variable, from the package's ``native/``.

Each check runs in a fresh process, which loads the four libraries
through the port's own loaders and reports where each is mapped
(/proc/self/maps).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from trust4_tpu_torch.utils import nativebuild

LIBS = ("libt4align.so", "libt4extract.so", "libt4overlap.so", "libt4bam.so")
_REPORT = '''
import json
from trust4_tpu_torch.align import native
from trust4_tpu_torch.engine import overlap_native
from trust4_tpu_torch.io import bam_native
from trust4_tpu_torch.pipeline import extract_native
from trust4_tpu_torch.tools.asan_check import mapped_libraries
loaded = [m._load() is not None
          for m in (native, overlap_native, bam_native, extract_native)]
maps = mapped_libraries()
print(json.dumps({"loaded": loaded, "maps": {
    k: v for k, v in maps.items() if k.startswith("libt4")}}))
'''


def loaded_from(env_dir=None) -> dict:
    """{library: [paths it is mapped from]} in a fresh process, with
    TRUST4_TPU_NATIVE_DIR set to ``env_dir`` (unset when None); asserts
    that the loaders loaded all four."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("TRUST4_TPU_NATIVE_DIR", "TRUST4_TPU_NATIVE")}
    if env_dir is not None:
        env["TRUST4_TPU_NATIVE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _REPORT], capture_output=True,
                       text=True, env=env, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["loaded"] == [True] * 4, rep
    return rep["maps"]


def native_copy(dest: str) -> str:
    """A copy of the package's ``native/`` (sources, Makefile and the
    built libraries, modification times kept, so ``make`` finds them up
    to date) at ``dest``."""
    for lib in LIBS:
        nativebuild.ensure_built(lib)
    shutil.copytree(nativebuild.NATIVE_DIR, dest,
                    ignore=shutil.ignore_patterns(".build.lock", "asan"))
    return dest


def test_native_dir_loads_all_four_from_there(tmp_path):
    d = native_copy(str(tmp_path / "native"))
    maps = loaded_from(d)
    for lib in LIBS:
        assert [os.path.dirname(os.path.realpath(p)) for p in maps[lib]] == [
            os.path.realpath(d)], (lib, maps)
    assert os.path.exists(os.path.join(d, ".build.lock"))


def test_without_native_dir_nothing_changes(tmp_path, monkeypatch):
    monkeypatch.delenv("TRUST4_TPU_NATIVE_DIR", raising=False)
    assert nativebuild.native_dir() == nativebuild.NATIVE_DIR
    maps = loaded_from(None)
    for lib in LIBS:
        assert [os.path.realpath(p) for p in maps[lib]] == [
            os.path.realpath(os.path.join(nativebuild.NATIVE_DIR, lib))], maps
    # An empty value is unset too.
    monkeypatch.setenv("TRUST4_TPU_NATIVE_DIR", "")
    assert nativebuild.native_dir() == nativebuild.NATIVE_DIR


def test_native_dir_builds_a_missing_library_there(tmp_path, monkeypatch):
    """``ensure_built`` runs make in the named directory: a library
    missing there is built there (libt4extract.so: nothing else is built
    from it), and the package's own is left as it was."""
    d = native_copy(str(tmp_path / "native"))
    os.remove(os.path.join(d, "libt4extract.so"))
    own = os.path.join(nativebuild.NATIVE_DIR, "libt4extract.so")
    before = os.stat(own).st_mtime_ns
    monkeypatch.setenv("TRUST4_TPU_NATIVE_DIR", d)
    assert nativebuild.native_dir() == os.path.abspath(d)
    path = nativebuild.ensure_built("libt4extract.so")
    assert path == os.path.join(os.path.abspath(d), "libt4extract.so")
    assert os.path.exists(path)
    assert os.stat(own).st_mtime_ns == before


def test_native_dir_without_sources_raises(tmp_path, monkeypatch):
    """A directory that holds neither the library nor its Makefile: the
    build fails (the loaders then load nothing: no load from
    elsewhere)."""
    monkeypatch.setenv("TRUST4_TPU_NATIVE_DIR", str(tmp_path))
    with pytest.raises(subprocess.CalledProcessError):
        nativebuild.ensure_built("libt4align.so")
