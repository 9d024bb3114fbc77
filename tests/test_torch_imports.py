"""The port and chip_smoke.py import nothing of JAX, Flax, PyYAML, OpenCV
or the JAX package: the GPU machine that runs them has none of those.
Every module of behindthescenes_tpu_torch and chip_smoke.py (without
running its main) is imported in a fresh interpreter where those modules
are blocked, and the sources are searched for such imports."""
import os
import re
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "behindthescenes_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "behindthescenes_tpu")

_PROBE = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = {blocked!r}

def _blocked(name):
    return name.split(".")[0] in BLOCKED

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError(f"blocked import: {{name}}")
        return None

for mod in [m for m in sys.modules if _blocked(m)]:
    del sys.modules[mod]
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import behindthescenes_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_with_jax_family_blocked():
    code = _PROBE.format(blocked=BLOCKED, root=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_imports_in_the_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|yaml|cv2|"
                     r"behindthescenes_tpu)(\.|\s|$)", re.M)
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not pat.search(text), path
        assert "import jax" not in text, path
        assert "behindthescenes_tpu." not in text, path


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else, the run
    exits non-zero and prints no result (here: no CUDA device either)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=tmp_path,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_source_scan_covers_the_kitti360_path():
    """The scan and the blocked-import probe reach the KITTI-360 loader,
    its PNG and resize code, the occupancy evaluators and the port's own
    tree generator and preprocessor (which replace scripts that import
    cv2 and yaml)."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join("datasets", f) for f in (
        "png.py", "kitti_360.py", "kitti_360_labels.py",
        "gen_synthetic_kitti_360.py", "preprocess_kitti_360.py")} \
        | {os.path.join("evaluation", f) for f in (
            "lidar_occ.py", "bbox_occ.py")} <= scanned
