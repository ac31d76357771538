"""The port's native-library loader under concurrent first use.

Six processes start together on a fresh copy of the loader and the C++
source (no library built yet), while ``make -C native`` (the JAX
package's build) runs in the same copy.  Each process must load a
library: the port builds into a private, hashed path under an exclusive
lock and renames the finished file into place, so no process loads a
file that another is still writing.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOAD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
lib = native.get_lib()
print("loaded" if lib is not None else "none", native.library_path())
"""


@pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None
                    or shutil.which("make") is None,
                    reason="needs a C++ compiler and make")
def test_six_processes_on_a_fresh_build_all_load(tmp_path):
    os.makedirs(tmp_path / "amrvolumerenderer_torch")
    shutil.copytree(os.path.join(REPO, "native"), tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    loader = tmp_path / "amrvolumerenderer_torch" / "native.py"
    shutil.copy(os.path.join(REPO, "amrvolumerenderer_torch", "native.py"), loader)
    assert not (tmp_path / "build").exists()

    make = subprocess.Popen(["make", "-C", str(tmp_path / "native"), "-s"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(loader)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    make.communicate(timeout=300)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    results = [out.split() for out, _ in outs]
    assert [r[0] for r in results] == ["loaded"] * 6
    paths = {r[1] for r in results}
    assert len(paths) == 1
    path = paths.pop()
    assert path.startswith(str(tmp_path / "build" / "native"))
    # one finished library and the lock; no temporary file left behind
    assert sorted(os.listdir(tmp_path / "build" / "native")) == [
        ".lock", os.path.basename(path)]
