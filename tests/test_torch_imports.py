"""The port and chip_smoke.py import nothing of JAX, Flax, PyYAML, OpenCV,
PIL, matplotlib, h5py, scipy or the JAX package: the GPU machine that runs
them has none of those.
Every module of behindthescenes_tpu_torch and chip_smoke.py (without
running its main) is imported in a fresh interpreter where those modules
are blocked, and the sources are searched for such imports."""
import os
import re
import subprocess
import sys

import torch
# One intra-op thread: pytest-xdist runs several workers on this CPU,
# and torch's default of a thread per core makes every small op wait
# on threads that the other workers have swapped out.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "behindthescenes_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "cv2", "PIL", "matplotlib",
           "h5py", "scipy", "behindthescenes_tpu")

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
assert {{"behindthescenes_tpu_torch.parallel.mesh",
        "behindthescenes_tpu_torch.parallel.launch"}} <= set(names), names
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


_PARALLEL_PROBE = _PROBE.split("import behindthescenes_tpu_torch as pkg")[0] \
    + r"""
import behindthescenes_tpu_torch.parallel.launch as launch
import behindthescenes_tpu_torch.parallel.mesh as mesh
import behindthescenes_tpu_torch.platform as platform
assert mesh.default_group() is None and mesh.eval_group() is None
assert mesh.init_distributed({{}}) == (0, 1)
platform.multihost_barrier()
assert callable(launch.run_ranks)
leaked = sorted(m for m in sys.modules if _blocked(m))
assert not leaked, leaked
print("ok")
"""


def test_parallel_imports_with_jax_family_blocked():
    """The multi-rank package alone (what a torchrun rank loads first),
    with its single-process paths run: no group, no rendezvous."""
    code = _PARALLEL_PROBE.format(blocked=BLOCKED, root=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_imports_in_the_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|yaml|cv2|PIL|"
                     r"matplotlib|h5py|scipy|behindthescenes_tpu)(\.|\s|$)",
                     re.M)
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


def test_source_scan_covers_the_training_remainder():
    """The scan and the blocked-import probe reach the image processors,
    the visualisation grids and the plotting helpers that carry their own
    colormap in place of matplotlib's."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join(*f) for f in (
        ("models", "image_processor.py"), ("training", "visualize.py"),
        ("utils", "plotting.py"))} <= scanned


def test_source_scan_covers_the_kitti_raw_and_re10k_path():
    """The scan and the blocked-import probe reach the JPEG codec, the
    KITTI raw and RealEstate10K loaders (which replace loaders that read
    through cv2) and the port's two tree generators."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join("datasets", f) for f in (
        "jpeg.py", "kitti_raw.py", "realestate10k.py",
        "gen_synthetic_kitti_raw.py", "gen_synthetic_re10k.py")} <= scanned


def test_source_scan_covers_the_sweep_and_the_demos():
    """The scan and the blocked-import probe reach the sweep renderer, the
    image IO that replaces cv2's, and the demo scripts."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join(*f) for f in (
        ("models", "sweep.py"), ("utils", "io.py"),
        ("scripts", "__init__.py"), ("scripts", "inference_setup.py"),
        ("scripts", "gen_img_custom.py"), ("scripts", "gen_imgs.py"))} \
        <= scanned


def test_source_scan_covers_the_other_loaders_and_model_extras():
    """The scan and the blocked-import probe (h5py and scipy blocked too)
    reach the KITTI odometry, Waymo, NYU v2, VIPER and TRI-PD loaders,
    the HDF5 reader that replaces h5py, the tree generators of the new
    datasets, the 3D-conv blocks, the layer extras, the mesh extraction
    and the segmentation metrics."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join(*f) for f in (
        ("datasets", "kitti_odom.py"), ("datasets", "waymo.py"),
        ("datasets", "hdf5.py"), ("datasets", "nyu_depth_v2.py"),
        ("datasets", "viper.py"), ("datasets", "tri_pd.py"),
        ("datasets", "gen_synthetic_kitti_odom.py"),
        ("datasets", "gen_synthetic_waymo.py"),
        ("models", "resnet3dconv.py"), ("ops", "layers_extra.py"),
        ("utils", "recon.py"), ("utils", "metrics_extra.py"))} <= scanned


def test_source_scan_covers_the_video_scripts_and_the_writer():
    """The scan and the blocked-import probe reach the three video
    scripts, the Motion-JPEG writer that replaces cv2.VideoWriter and the
    ORB-SLAM settings script. tools/orbax_to_port.py is outside the port
    and exempt: it restores the JAX package's orbax checkpoints, so it
    runs where jax and orbax are, and only its output reaches the
    port."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    assert {os.path.join(*f) for f in (
        ("utils", "video.py"), ("scripts", "gen_vid_nvs.py"),
        ("scripts", "gen_vid_transition.py"), ("scripts", "gen_vid_seq.py"),
        ("scripts", "gen_orbslam_settings.py"))} <= scanned
