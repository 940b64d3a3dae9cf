"""COLMAP interop: text sparse models and the SQLite feature database.

Capability parity with
* SfM::WriteCOLMAP (/root/reference/src/sfm.cpp:573-647) — text model with
  one shared SIMPLE_PINHOLE camera, observations re-centered at the principal
  point, 1-based ids;
* COLMAP::Database (/root/reference/examples/colmap.{h,cpp}) — read cameras /
  images / keypoints / descriptors / two-view matches from a COLMAP SQLite
  database (pair_id = id1·2147483647 + id2), and write the full schema back;
* the text/binary model *readers* of the evaluation scripts
  (/root/reference/scripts/colmap_utils.py) used by the PhoneSweep evaluator.

Python's stdlib sqlite3 replaces the reference's C SQLite binding — the
database work is I/O-bound host code, not a compute path.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Dict, NamedTuple

import numpy as np

MAX_IMAGE_ID = 2147483647


# --- quaternion helpers (COLMAP uses w,x,y,z; world->camera) ----------------

def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (w, x, y, z), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        return np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
        )
    s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
    return np.array(
        [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
         (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    )


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


# --- text model writer ------------------------------------------------------

def write_colmap_text(sfm_map, sparse_dir: str, width: int, height: int):
    """Write cameras.txt / images.txt / points3D.txt like the reference.

    Host-numpy exp: writers stay off the device, and the jnp path once
    silently corrupted written rotations through a reduced-precision
    default matmul (see geometry/so3.py::_exp)."""
    from ..geometry.so3 import np_so3_exp  # local import to avoid cycles

    os.makedirs(sparse_dir, exist_ok=True)
    focal = float(np.asarray(sfm_map.intrinsics.focal))
    cx = float(np.asarray(sfm_map.intrinsics.cx))
    cy = float(np.asarray(sfm_map.intrinsics.cy))

    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write("# Number of cameras: 1\n")
        f.write(f"1 SIMPLE_PINHOLE {width} {height} {focal:.6f} {cx:.6f} {cy:.6f}\n")

    valid_pt = sfm_map.point_valid()
    R_all = np_so3_exp(np.asarray(sfm_map.cam_r, np.float64))
    point_obs: Dict[int, list] = {j: [] for j in range(sfm_map.num_points)}

    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {sfm_map.num_cameras}, mean observations per image:\n")
        for i in range(sfm_map.num_cameras):
            q = rotmat_to_quat(R_all[i])
            t = sfm_map.cam_t[i]
            name = sfm_map.paths[i] if i < len(sfm_map.paths) else f"{i:06d}.png"
            f.write(
                f"{i + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} 1 {name}\n"
            )
            sel = np.nonzero(
                (sfm_map.obs_cam == i) & sfm_map.obs_valid
                & valid_pt[sfm_map.obs_pt]
            )[0]
            parts = []
            for k, o in enumerate(sel):
                j = int(sfm_map.obs_pt[o])
                uv = sfm_map.obs_uv[o]
                parts.append(f"{uv[0] + cx:.6f} {uv[1] + cy:.6f} {j + 1}")
                point_obs[j].append((i + 1, k))
            f.write(" ".join(parts) + "\n")

    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {sfm_map.num_points}, mean track length: \n")
        for j in np.nonzero(valid_pt)[0]:
            X = sfm_map.points[j]
            col = sfm_map.colors[j] if j < len(sfm_map.colors) else (0, 0, 0)
            track = " ".join(f"{im} {k}" for im, k in point_obs[int(j)])
            f.write(
                f"{j + 1} {X[0]:.6f} {X[1]:.6f} {X[2]:.6f} "
                f"{int(col[0])} {int(col[1])} {int(col[2])} 0 {track}\n"
            )


# --- text model reader (evaluator-compatible) --------------------------------

class ColmapModel(NamedTuple):
    cameras: dict     # camera_id -> dict(model, width, height, params)
    images: dict      # image_id -> dict(name, q(wxyz), t, camera_id, xys, point3D_ids)
    points: dict      # point3D_id -> dict(xyz, rgb, track)


def read_colmap_text(sparse_dir: str) -> ColmapModel:
    cameras = {}
    with open(os.path.join(sparse_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cameras[int(el[0])] = dict(
                model=el[1], width=int(el[2]), height=int(el[3]),
                params=np.array([float(x) for x in el[4:]]),
            )
    images = {}
    with open(os.path.join(sparse_dir, "images.txt")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    for a in range(0, len(lines) - 1, 2):
        el = lines[a].split()
        if len(el) < 10:
            continue
        data = lines[a + 1].split()
        xys = np.array(
            [[float(data[k]), float(data[k + 1])] for k in range(0, len(data), 3)]
        ) if data else np.zeros((0, 2))
        pids = np.array(
            [int(data[k + 2]) for k in range(0, len(data), 3)], np.int64
        ) if data else np.zeros(0, np.int64)
        images[int(el[0])] = dict(
            q=np.array([float(x) for x in el[1:5]]),
            t=np.array([float(x) for x in el[5:8]]),
            camera_id=int(el[8]), name=el[9], xys=xys, point3D_ids=pids,
        )
    points = {}
    pts_path = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(pts_path):
        with open(pts_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                el = line.split()
                points[int(el[0])] = dict(
                    xyz=np.array([float(x) for x in el[1:4]]),
                    rgb=np.array([int(x) for x in el[4:7]], np.uint8),
                    track=np.array([int(x) for x in el[8:]], np.int64).reshape(-1, 2),
                )
    return ColmapModel(cameras=cameras, images=images, points=points)


def read_colmap_binary(sparse_dir: str) -> ColmapModel:
    """Binary sparse model reader (cameras.bin/images.bin/points3D.bin),
    format-compatible with the evaluation scripts' readers
    (scripts/colmap_utils.py)."""
    num_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12}
    model_name = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL",
                  3: "RADIAL", 4: "OPENCV", 5: "OPENCV_FISHEYE",
                  6: "FULL_OPENCV", 7: "FOV", 8: "SIMPLE_RADIAL_FISHEYE",
                  9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE"}
    cameras = {}
    with open(os.path.join(sparse_dir, "cameras.bin"), "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            params = struct.unpack("<" + "d" * num_params[model],
                                   f.read(8 * num_params[model]))
            cameras[cid] = dict(model=model_name[model], width=w, height=h,
                                params=np.array(params))
    images = {}
    with open(os.path.join(sparse_dir, "images.bin"), "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<dddd", f.read(32)))
            t = np.array(struct.unpack("<ddd", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            npts = struct.unpack("<Q", f.read(8))[0]
            data = struct.unpack("<" + "ddq" * npts, f.read(24 * npts))
            xys = np.array(data).reshape(-1, 3)[:, :2] if npts else np.zeros((0, 2))
            pids = np.array(data[2::3], np.int64) if npts else np.zeros(0, np.int64)
            images[iid] = dict(q=q, t=t, camera_id=cam_id,
                               name=name.decode("utf-8"), xys=xys,
                               point3D_ids=pids)
    points = {}
    p3d = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(p3d):
        with open(p3d, "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            for _ in range(n):
                pid = struct.unpack("<Q", f.read(8))[0]
                xyz = np.array(struct.unpack("<ddd", f.read(24)))
                rgb = np.array(struct.unpack("<BBB", f.read(3)), np.uint8)
                _err = struct.unpack("<d", f.read(8))[0]
                tl = struct.unpack("<Q", f.read(8))[0]
                track = np.array(struct.unpack("<" + "ii" * tl, f.read(8 * tl)),
                                 np.int64).reshape(-1, 2)
                points[pid] = dict(xyz=xyz, rgb=rgb, track=track)
    return ColmapModel(cameras=cameras, images=images, points=points)


def read_colmap_model(sparse_dir: str) -> ColmapModel:
    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        return read_colmap_binary(sparse_dir)
    return read_colmap_text(sparse_dir)


# --- SQLite feature database -------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_to_image_ids(pair_id: int):
    id2 = pair_id % MAX_IMAGE_ID
    id1 = (pair_id - id2) // MAX_IMAGE_ID
    return id1, id2


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


class ColmapDatabase(NamedTuple):
    """In-memory view of a COLMAP feature database."""

    intrinsics: tuple          # (focal, cx, cy) of the first camera
    width: int
    height: int
    names: list                # image names, ordered by image_id
    keypoints: list            # per image (N, 2) float32 pixel coords
    descriptors: list          # per image (N, 128) float32 (L2-normalized)
    matches: dict              # (idx_i, idx_j) -> (M, 2) int32 index pairs


def read_database(path: str, use_two_view_geometry: bool = True) -> ColmapDatabase:
    """Read features/matches (reference COLMAP::Database::read,
    colmap.cpp:53-188; SIMPLE_PINHOLE assumed like the reference)."""
    con = sqlite3.connect(path)
    cur = con.cursor()

    cam = cur.execute(
        "SELECT camera_id, model, width, height, params FROM cameras"
    ).fetchone()
    if cam is None:
        raise ValueError(f"no cameras in {path}")
    params = np.frombuffer(cam[4], np.float64)
    focal, cx, cy = params[0], params[1], params[2]
    width, height = int(cam[2]), int(cam[3])

    rows = cur.execute("SELECT image_id, name FROM images ORDER BY image_id").fetchall()
    ids = [r[0] for r in rows]
    names = [r[1] for r in rows]
    id_to_idx = {img_id: k for k, img_id in enumerate(ids)}

    keypoints = [np.zeros((0, 2), np.float32) for _ in ids]
    for img_id, r, c, blob in cur.execute(
        "SELECT image_id, rows, cols, data FROM keypoints"
    ):
        if img_id not in id_to_idx or r == 0:
            continue
        arr = np.frombuffer(blob, np.float32).reshape(r, c)
        keypoints[id_to_idx[img_id]] = arr[:, :2].copy()

    descriptors = [np.zeros((0, 128), np.float32) for _ in ids]
    for img_id, r, c, blob in cur.execute(
        "SELECT image_id, rows, cols, data FROM descriptors"
    ):
        if img_id not in id_to_idx or r == 0:
            continue
        arr = np.frombuffer(blob, np.uint8).reshape(r, c).astype(np.float32)
        descriptors[id_to_idx[img_id]] = arr

    matches = {}
    table = "two_view_geometries" if use_two_view_geometry else "matches"
    try:
        rows_iter = list(cur.execute(f"SELECT pair_id, rows, cols, data FROM {table}"))
    except sqlite3.OperationalError:
        rows_iter = []
    if not rows_iter and table != "matches":
        # verified two-view geometries absent (e.g. database written before
        # geometric verification) — fall back to the raw matches table
        rows_iter = list(cur.execute("SELECT pair_id, rows, cols, data FROM matches"))
    for pair_id, r, c, blob in rows_iter:
        if r == 0 or blob is None:
            continue
        id1, id2 = pair_id_to_image_ids(pair_id)
        if id1 not in id_to_idx or id2 not in id_to_idx:
            continue
        arr = np.frombuffer(blob, np.uint32).reshape(r, c).astype(np.int32)
        matches[(id_to_idx[id1], id_to_idx[id2])] = arr[:, :2]
    con.close()
    return ColmapDatabase(
        intrinsics=(float(focal), float(cx), float(cy)),
        width=width, height=height, names=names,
        keypoints=keypoints, descriptors=descriptors, matches=matches,
    )


def write_database(path: str, db: ColmapDatabase):
    """Create the COLMAP schema and insert cameras/images/keypoints/matches
    (reference COLMAP::Database::write, colmap.cpp:190-300)."""
    con = sqlite3.connect(path)
    cur = con.cursor()
    cur.executescript(_SCHEMA)
    focal, cx, cy = db.intrinsics
    params = np.array([focal, cx, cy], np.float64).tobytes()
    cur.execute(
        "INSERT INTO cameras (camera_id, model, width, height, params, prior_focal_length)"
        " VALUES (1, 0, ?, ?, ?, 0)",
        (db.width, db.height, params),
    )
    for k, name in enumerate(db.names):
        cur.execute(
            "INSERT INTO images (image_id, name, camera_id) VALUES (?, ?, 1)",
            (k + 1, name),
        )
        kp = np.asarray(db.keypoints[k], np.float32)
        kp6 = np.zeros((kp.shape[0], 6), np.float32)
        kp6[:, :2] = kp
        kp6[:, 2] = 1.0
        cur.execute(
            "INSERT INTO keypoints (image_id, rows, cols, data) VALUES (?, ?, ?, ?)",
            (k + 1, kp6.shape[0], 6, kp6.tobytes()),
        )
        if db.descriptors and len(db.descriptors[k]):
            d = np.clip(np.asarray(db.descriptors[k]), 0, 255).astype(np.uint8)
            cur.execute(
                "INSERT INTO descriptors (image_id, rows, cols, data) VALUES (?, ?, ?, ?)",
                (k + 1, d.shape[0], d.shape[1], d.tobytes()),
            )
    for (i, j), m in db.matches.items():
        pid = image_ids_to_pair_id(i + 1, j + 1)
        arr = np.asarray(m, np.uint32)
        cur.execute(
            "INSERT OR REPLACE INTO matches (pair_id, rows, cols, data) VALUES (?, ?, ?, ?)",
            (pid, arr.shape[0], 2, arr.tobytes()),
        )
    con.commit()
    con.close()
