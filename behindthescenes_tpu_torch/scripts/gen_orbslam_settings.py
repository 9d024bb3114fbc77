"""Per-day ORB-SLAM3 stereo settings for KITTI raw from the dataset's own
calibration files (counterpart of the repository's
scripts/datasets/gen_orbslam_settings.py, whose output it writes byte
for byte; the JAX script imports behindthescenes_tpu/datasets/kitti_raw.py,
which imports cv2). Every camera number of the settings comes from a
day's `calib_cam_to_cam.txt` (P_rect_02 / P_rect_03 for the rectified
stereo pair, S_rect_02 for the image size); the rest are the standard
ORB-SLAM KITTI stereo parameters.

    python -m behindthescenes_tpu_torch.scripts.gen_orbslam_settings \\
        -d data/KITTI-Raw -o orb-slam_settings
"""
from __future__ import annotations

import argparse
from pathlib import Path

from behindthescenes_tpu_torch.datasets.kitti_raw import parse_calib_file

# Standard ORB-SLAM stereo parameters for KITTI (10 Hz rectified pairs).
FPS = 10
TH_DEPTH = 35.0
ORB = {"nFeatures": 2000, "scaleFactor": 1.2, "nLevels": 8,
       "iniThFAST": 20, "minThFAST": 7}

TEMPLATE = """\
%YAML:1.0

File.version: "1.0"

Camera.type: "Rectified"

# Derived from {day}/calib_cam_to_cam.txt (P_rect_02 / P_rect_03).
Camera1.fx: {fx:.6e}
Camera1.fy: {fy:.6e}
Camera1.cx: {cx:.6e}
Camera1.cy: {cy:.6e}

Camera2.fx: {fx:.6e}
Camera2.fy: {fy:.6e}
Camera2.cx: {cx:.6e}
Camera2.cy: {cy:.6e}

Camera.width: {width}
Camera.height: {height}

Camera.fps: {fps}

# Rectified stereo baseline in meters: (P_rect_02 - P_rect_03)[0,3] / fx.
Stereo.b: {baseline:.8f}

Camera.RGB: 1

# Close/far point threshold, in baselines.
Stereo.ThDepth: {th_depth}

# ORB extractor (standard KITTI stereo configuration).
ORBextractor.nFeatures: {nFeatures}
ORBextractor.scaleFactor: {scaleFactor}
ORBextractor.nLevels: {nLevels}
ORBextractor.iniThFAST: {iniThFAST}
ORBextractor.minThFAST: {minThFAST}

# Viewer (deactivated by the headless pose runner).
Viewer.KeyFrameSize: 0.6
Viewer.KeyFrameLineWidth: 2.0
Viewer.GraphLineWidth: 1.0
Viewer.PointSize: 2.0
Viewer.CameraSize: 0.7
Viewer.CameraLineWidth: 3.0
Viewer.ViewpointX: 0.0
Viewer.ViewpointY: -100.0
Viewer.ViewpointZ: -0.1
Viewer.ViewpointF: 2000.0
"""


def settings_for_day(calib_path: Path, day: str) -> str:
    cam = parse_calib_file(calib_path)
    p_l = cam["P_rect_02"].reshape(3, 4)
    p_r = cam["P_rect_03"].reshape(3, 4)
    fx = float(p_l[0, 0])
    baseline = float((p_l[0, 3] - p_r[0, 3]) / fx)
    width, height = (int(round(v)) for v in cam["S_rect_02"])
    return TEMPLATE.format(
        day=day, fx=fx, fy=float(p_l[1, 1]), cx=float(p_l[0, 2]),
        cy=float(p_l[1, 2]), width=width, height=height, fps=FPS,
        baseline=baseline, th_depth=TH_DEPTH, **ORB)


def main(argv=None) -> list:
    """Writes <out>/<day>.yaml for each day directory with a calibration;
    returns the files written."""
    parser = argparse.ArgumentParser("KITTI-Raw ORB-SLAM settings generator")
    parser.add_argument("--data-path", "-d", required=True,
                        help="KITTI-Raw root containing day directories")
    parser.add_argument("--out-path", "-o", required=True)
    args = parser.parse_args(argv)

    out_root = Path(args.out_path)
    out_root.mkdir(parents=True, exist_ok=True)
    days = sorted(d for d in Path(args.data_path).iterdir()
                  if d.is_dir() and (d / "calib_cam_to_cam.txt").exists())
    if not days:
        raise SystemExit(f"no day directories with calib files under "
                         f"{args.data_path}")
    written = []
    for day_dir in days:
        text = settings_for_day(day_dir / "calib_cam_to_cam.txt",
                                day_dir.name)
        out_file = out_root / f"{day_dir.name}.yaml"
        out_file.write_text(text)
        print(f"wrote {out_file}")
        written.append(out_file)
    return written


if __name__ == "__main__":
    main()
