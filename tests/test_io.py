"""IO tests: feature-track cache roundtrip, NeRF export, poses read/write."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from sphericalsfm_tpu.io import (
    export_nerf,
    read_feature_tracks,
    read_poses,
    write_feature_tracks,
)


def test_feature_tracks_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    kps = [rng.random((5, 2)).astype(np.float32),
           rng.random((7, 2)).astype(np.float32)]
    ds = [rng.random((5, 128)).astype(np.float32),
          rng.random((7, 128)).astype(np.float32)]
    ms = [np.array([[0, 1], [2, 3]])]
    Rs = rng.random((1, 3, 3))
    write_feature_tracks(str(tmp_path), [10, 20], kps, ds, [0], [1], ms, Rs)
    fi, kp2, d2, pi, pj, m2, R2 = read_feature_tracks(str(tmp_path))
    assert list(fi) == [10, 20]
    np.testing.assert_allclose(kp2[1], kps[1])
    np.testing.assert_allclose(d2[0], ds[0])
    np.testing.assert_array_equal(m2[0], ms[0])
    np.testing.assert_allclose(R2, Rs)
    assert pi[0] == 0 and pj[0] == 1


def test_poses_and_nerf_export(tmp_path):
    from sphericalsfm_tpu.geometry import Intrinsics
    from sphericalsfm_tpu.pipeline.sfm import SfMMap

    rng = np.random.default_rng(1)
    m = SfMMap(Intrinsics(jnp.asarray(300.0), jnp.asarray(160.0), jnp.asarray(120.0)))
    C = 6
    m.cam_r = rng.normal(size=(C, 3)) * 0.3
    m.cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    m.paths = [f"{i:06d}.png" for i in range(C)]
    poses = tmp_path / "poses.txt"
    m.write_poses(str(poses))

    idx, ts, rs = read_poses(str(poses))
    np.testing.assert_allclose(ts, m.cam_t, atol=1e-12)
    np.testing.assert_allclose(rs, m.cam_r, atol=1e-12)

    calib = tmp_path / "calib.txt"
    calib.write_text("300.0 160.0 120.0\n")
    out = tmp_path / "transforms.json"
    export_nerf(str(poses), str(calib), str(out), 320, 240)
    data = json.loads(out.read_text())
    assert len(data["frames"]) == C
    assert abs(data["fl_x"] - 300.0) < 1e-9
    M = np.asarray(data["frames"][0]["transform_matrix"])
    assert M.shape == (4, 4)
    np.testing.assert_allclose(M[3], [0, 0, 0, 1])
    # camera centers normalized to ~4 units from the attention center
    centers = np.stack([np.asarray(f["transform_matrix"])[:3, 3] for f in data["frames"]])
    assert 1.0 < np.linalg.norm(centers, axis=-1).mean() < 8.0


def test_undistort_cli(tmp_path):
    """D3 undistort_images: image-sequence input → undistorted PNGs +
    pinhole intrinsics (reference undistort_images.cpp:23-97)."""
    import sys

    import cv2

    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(d / f"{i:02d}.png"),
                    rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
    (d / "intr.txt").write_text("60 32 24\n")
    out = tmp_path / "und"
    argv_save = sys.argv
    sys.argv = ["prog", "undistort", "--images", str(d / "%02d.png"),
                "--intrinsics", str(d / "intr.txt"),
                "--distortion", "0.1,-0.05", "--output", str(out)]
    try:
        from sphericalsfm_tpu.cli import main

        main()
    finally:
        sys.argv = argv_save
    assert sorted(p.name for p in out.iterdir()) == [
        "000000.png", "000001.png", "000002.png", "intrinsics.txt"]
    focal, cx, cy = (float(x)
                     for x in (out / "intrinsics.txt").read_text().split())
    assert 30 < focal < 120 and 0 < cx < 64 and 0 < cy < 48


def test_experiment_runners(tmp_path):
    """Smoke: the E5-parity experiment harness produces CSV artifacts."""
    from sphericalsfm_tpu.eval.experiments import (
        noise_experiment, stability_experiment, timing_experiment,
        ransac_experiment,
    )

    rows = noise_experiment(str(tmp_path / "noise.csv"),
                            noises_px=(0.0, 1.0), trials=200)
    assert rows[0]["median_frob"] < 1e-8 < rows[1]["median_frob"] < 1.0
    st = stability_experiment(str(tmp_path / "stab.csv"), trials=500)
    assert st["median"] < -8
    t = timing_experiment(str(tmp_path / "time.csv"), batch=512, reps=3)
    assert t["solves_per_s"] > 100
    r = ransac_experiment(str(tmp_path / "ransac.csv"), trials=16)
    assert r["median_rot_deg"] < 0.5
    for f in ("noise.csv", "stab.csv", "time.csv", "ransac.csv"):
        assert (tmp_path / f).exists()


def _decode_png(path):
    """Independent decoder for what write_png emits: chunk CRCs, IHDR,
    zlib-inflated scanlines with filter type 0."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[b"IHDR"])
    assert depth == 8 and interlace == 0 and b"IEND" in chunks
    c = {0: 1, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (4, 3, 4)])
def test_png_round_trip(tmp_path, shape):
    from sphericalsfm_tpu.io.png import write_png

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = _decode_png(path)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
