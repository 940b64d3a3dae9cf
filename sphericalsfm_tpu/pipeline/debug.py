"""Visual debug artifacts for reconstruction runs.

`write_reprojection_overlays` is this pipeline's analogue of the
reference's show_reprojection_error renderer
(examples/spherical_sfm_tools.cpp:957-1005): every observation is drawn on
its frame at the observed pixel, colored yellow→red by the magnitude of its
reprojection error (clamped at `max_err_px`), one JPEG per camera. All
numpy + OpenCV — a pure host-side artifact path, never on the device.
"""

from __future__ import annotations

import os

import numpy as np


def write_reprojection_overlays(
    m,
    frames: np.ndarray,
    out_dir: str,
    max_err_px: float = 10.0,
) -> int:
    """Draw observed points colored by reprojection error on every frame.

    `m` is an SfMMap (numpy-backed); `frames` is (F, H, W) gray or
    (F, H, W, 3) BGR uint8, one per camera (extra frames ignored, missing
    frames skipped). Returns the number of images written to
    `out_dir/reproj%06d.jpg`.
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cx = float(np.asarray(m.intrinsics.cx))
    cy = float(np.asarray(m.intrinsics.cy))

    # reprojection errors of every live observation, vectorized host-side
    live = m.obs_valid & (np.linalg.norm(m.points[m.obs_pt], axis=-1) > 0)
    err = m.reprojection_errors()

    n_written = 0
    F = min(m.num_cameras, len(frames))
    for i in range(F):
        img = np.asarray(frames[i])
        if img.dtype != np.uint8:  # frontend gray frames are float in [0,1]
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        else:
            img = img.copy()
        sel = np.nonzero(live & (m.obs_cam == i))[0]
        for k in sel:
            d = min(float(err[k]), max_err_px)
            # yellow (accurate) → red (at/beyond the clamp), BGR like the
            # reference's cv::Scalar(0, (1-d/10)*255, 255)
            color = (0, int((1.0 - d / max_err_px) * 255), 255)
            loc = (
                int(round(m.obs_uv[k, 0] + cx)),
                int(round(m.obs_uv[k, 1] + cy)),
            )
            cv2.circle(img, loc, 3, color, -1)
        cv2.imwrite(os.path.join(out_dir, f"reproj{i:06d}.jpg"), img)
        n_written += 1
    return n_written
