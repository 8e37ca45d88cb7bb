"""The first-use build of the native library, with processes and threads
that need it at once.

The JAX package's loader (aletsch_tpu/io/bam_native.py) runs make when
native/libabam.so is missing and then opens the file; make links it in
place.  A process that finds the file while another one is still linking
it opens a partial library, fails, and keeps the failure for the life of
the process: test workers that collect at once all race so.  These tests
pin that behaviour on a stand-in native directory whose make writes a
whole library slowly in place, hold the port's test helpers to loading it
again once it is whole, and hold the port's loader
(aletsch_tpu_torch/io/bam_native.py::_build_lib) to one build that every
process waits for and that appears at its path only whole."""

import ctypes
import filecmp
import os
import subprocess
import sys
import threading
import time

from aletsch_tpu.io import bam_native as ref_bn
from aletsch_tpu_torch.io import bam_native as port_bn
import torch_helpers
from torch_helpers import REPO

# a linker that writes its output in place, body first and the ELF header
# last, pausing between the two
SLOW_LINK = """import sys, time
src, dst, pause, log = sys.argv[1:5]
with open(log, "a") as fh:
    fh.write("built\\n")
data = open(src, "rb").read()
with open(dst, "wb") as fh:
    fh.write(bytes(64) + data[64:])
    fh.flush()
    time.sleep(float(pause))
    fh.seek(0)
    fh.write(data[:64])
"""


def _native_dir(tmp_path, payload, pause):
    """A stand-in for native/: its Makefile 'links' libabam.so by copying
    `payload` slowly in place; every build appends a line to
    tmp_path/builds.log.  Returns (dir, log path)."""
    native = tmp_path / "native"
    native.mkdir()
    log = tmp_path / "builds.log"
    (native / "slow_link.py").write_text(SLOW_LINK)
    (native / "Makefile").write_text(
        "libabam.so:\n\t%s slow_link.py %s $@ %s %s\n"
        % (sys.executable, payload, pause, log))
    return str(native), log


def _wait_for(cond, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.01)


def test_reference_loader_keeps_a_failed_load_of_a_library_being_linked(
        tmp_path, monkeypatch):
    """Another process's first use is linking the library when this one
    opens it: the load fails, and the failure stays after the file is
    whole, though the whole file loads."""
    payload = port_bn._build_lib()
    native, log = _native_dir(tmp_path, payload, pause=3.0)
    so = os.path.join(native, "libabam.so")
    for name, value in (("_NATIVE_DIR", native), ("_SO_PATH", so),
                        ("_LIB", None), ("_LIB_TRIED", False)):
        monkeypatch.setattr(ref_bn, name, value)
    linker = subprocess.Popen(["make", "-s", "-C", native])
    try:
        _wait_for(lambda: os.path.exists(so))
        assert ref_bn._load_lib() is None
    finally:
        assert linker.wait(timeout=120) == 0
    assert filecmp.cmp(so, payload, shallow=False)
    assert ref_bn._load_lib() is None and not ref_bn.native_available()
    assert log.read_text() == "built\n"     # it never built it itself
    monkeypatch.setattr(ref_bn, "_LIB_TRIED", False)
    assert ref_bn._load_lib() is not None


def test_helpers_load_again_what_the_reference_loader_gave_up(
        tmp_path, monkeypatch):
    """The loader gave up while the library was being linked; the port's
    test helpers wait for the whole file and load it, so that this
    process's tests of both packages find it."""
    payload = port_bn._build_lib()
    native, _ = _native_dir(tmp_path, payload, pause=1.5)
    so = os.path.join(native, "libabam.so")
    for name, value in (("_NATIVE_DIR", native), ("_SO_PATH", so),
                        ("_LIB", None), ("_LIB_TRIED", False)):
        monkeypatch.setattr(ref_bn, name, value)
    linker = subprocess.Popen(["make", "-s", "-C", native])
    try:
        _wait_for(lambda: os.path.exists(so))
        assert ref_bn._load_lib() is None
        assert torch_helpers.load_reference_native() is True
        assert ref_bn.native_available()
    finally:
        assert linker.wait(timeout=120) == 0


def test_port_build_is_one_whole_library_for_concurrent_processes(tmp_path):
    """Four processes ask for the library at once from a directory without
    it: one builds, the others wait, every one loads the whole file, and
    nothing partial ever stands at its path."""
    payload = port_bn._build_lib()
    native, log = _native_dir(tmp_path, payload, pause=0.5)
    build = str(tmp_path / "build")
    code = ("import ctypes, sys\n"
            "from aletsch_tpu_torch.io import bam_native as b\n"
            "p = b._build_lib(sys.argv[1], sys.argv[2])\n"
            "ctypes.CDLL(p).abam_open\n"
            "print(p)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, native, build],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.dirname(path) == build
    assert log.read_text() == "built\n"
    assert filecmp.cmp(path, payload, shallow=False)
    assert sorted(os.listdir(build)) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".lock"])
    # the library's name follows the sources: an edit builds anew
    with open(os.path.join(native, "Makefile"), "a") as fh:
        fh.write("# edited\n")
    assert port_bn._build_lib(native, build) != path
    assert log.read_text() == "built\nbuilt\n"


def test_port_loader_makes_a_second_thread_wait(monkeypatch):
    """A thread that asks while another is loading gets the library, not
    the None of a load in progress."""
    payload = port_bn._build_lib()
    calls = []

    def slow_build():
        calls.append(1)
        time.sleep(0.5)
        return payload

    monkeypatch.setattr(port_bn, "_build_lib", slow_build)
    monkeypatch.setattr(port_bn, "_LIB", None)
    monkeypatch.setattr(port_bn, "_LIB_TRIED", False)
    got = []
    threads = [threading.Thread(target=lambda: got.append(port_bn._load_lib()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(got) == 2 and all(isinstance(g, ctypes.CDLL) for g in got)
    assert got[0] is got[1] and calls == [1]
