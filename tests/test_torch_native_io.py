"""The port's host IO library (csrc/sens_io.cpp through native.py) and the
readers on it, against the port's plain python readers and the JAX
package, on the same bytes. Exact: every header field, pose, timestamp,
payload and decoded depth is compared byte for byte.

Mirrors tests/test_io.py's TestNativeColmap, TestSensExporters,
TestNativeSensRobustness, TestNativeColmapRobustness and TestSensFuzz.
The JAX side runs its python readers (its native path patched off, as
its own tests do), so this file never builds the JAX package's library.
"""

import ctypes
import io as _io
import os
import struct
import zlib

import numpy as np
import pytest

from semantic_meshes.data2 import scannet as jscannet
from semantic_meshes.io import colmap as jcolmap
from semantic_meshes_torch import _build, native
from semantic_meshes_torch.data2 import SensFile, scannet
from semantic_meshes_torch.io import colmap as colmap_io


@pytest.fixture
def jax_python_readers(monkeypatch):
    """The JAX package's readers with their native path off."""
    import semantic_meshes.native as jnative

    monkeypatch.setattr(jscannet.SensFile, "_try_native",
                        lambda self, fn, mf: False)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


def _write_images_bin(path, images):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i", img.image_id))
            f.write(np.asarray(img.qvec, "<f8").tobytes())
            f.write(np.asarray(img.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", img.camera_id))
            f.write(img.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))  # two dummy 2D points
            f.write(np.zeros(2, dtype=[("x", "<f8"), ("y", "<f8"),
                                       ("id", "<i8")]).tobytes())


def _images(seed=7):
    rng = np.random.default_rng(seed)
    images = {}
    for i, name in enumerate(["b.png", "a.png", "c.png", "d/é.png"],
                             start=1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = colmap_io.ColmapImage(
            i, q, rng.normal(size=3), 1 + (i % 2), name
        )
    return images


def _same_images(a, b):
    assert set(a) == set(b)
    for iid in a:
        assert a[iid].image_id == b[iid].image_id == iid
        assert a[iid].camera_id == b[iid].camera_id
        assert a[iid].name == b[iid].name
        np.testing.assert_array_equal(a[iid].qvec, b[iid].qvec)
        np.testing.assert_array_equal(a[iid].tvec, b[iid].tvec)
        assert np.asarray(a[iid].qvec).dtype == np.float64


def _sens_frames(rng, n, hw, shuffle=False):
    frames, depths = [], []
    ts = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(n):
        depth = rng.integers(0, 5000, hw).astype("<u2")
        depths.append(depth)
        frames.append(dict(
            camera_to_world=np.eye(4) + i * 0.125,
            timestamp_color=int(ts[i]), timestamp_depth=int(ts[i]) + 7,
            color_data=rng.bytes(int(rng.integers(10, 200))),
            depth_data=zlib.compress(depth.tobytes()),
        ))
    return frames, depths


def _write(path, frames, hw=(6, 8), name="sensor"):
    scannet.write_sens(
        str(path), name, np.eye(4) * 2, np.eye(4), np.eye(4) * 3,
        np.eye(4), hw, hw, 1000.0, frames,
    )
    return path


HEADER = ("version", "sensor_name", "color_compression_type",
          "depth_compression_type", "color_width", "color_height",
          "depth_width", "depth_height", "depth_shift")
MATS = ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
        "extrinsic_depth")


def _same_sens(a, b, names=True):
    """Every header field, frame order, pose, timestamp and payload."""
    for k in HEADER:
        if k != "sensor_name" or names:
            assert getattr(a, k) == getattr(b, k), k
    for k in MATS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        np.testing.assert_array_equal(fa.camera_to_world, fb.camera_to_world)
        assert fa.camera_to_world.dtype == fb.camera_to_world.dtype
        for k in ("timestamp_color", "timestamp_depth", "color_size_bytes",
                  "depth_size_bytes"):
            assert getattr(fa, k) == getattr(fb, k), k
        assert bytes(fa.color_data) == bytes(fb.color_data)
        assert bytes(fa.depth_data) == bytes(fb.depth_data)


class TestNativeLibrary:
    def test_record_layouts_agree_with_c(self):
        lib = native.load()
        assert lib.sens_header_size() == ctypes.sizeof(native.SensHeaderC)
        assert lib.sens_record_size() == native.FRAME_RECORD_DTYPE.itemsize
        assert (lib.colmap_image_record_size()
                == native.COLMAP_IMAGE_DTYPE.itemsize)
        # natural alignment, as the C compiler lays the structs out
        assert native.FRAME_RECORD_DTYPE.itemsize == 112
        assert native.COLMAP_IMAGE_DTYPE.itemsize == 80
        assert native.SensHeaderC.num_frames.offset == \
            native.SensHeaderC.depth_shift.offset + 4
        assert native.SensHeaderC.sensor_name.offset == 304

    def test_header_fields_land_where_written(self, tmp_path):
        frames, _ = _sens_frames(np.random.default_rng(0), 3, (6, 8))
        data = _write(tmp_path / "h.sens", frames, name="cam-x").read_bytes()
        hdr = native.parse_header(data)
        assert hdr.version == 4 and hdr.sensor_name == b"cam-x"
        assert (hdr.color_width, hdr.color_height) == (8, 6)
        assert (hdr.depth_width, hdr.depth_height) == (8, 6)
        assert (hdr.color_compression, hdr.depth_compression) == (2, 1)
        assert hdr.depth_shift == 1000.0 and hdr.num_frames == 3
        assert hdr.frames_start == 4 + 8 + 5 + 4 * 64 + 8 + 16 + 4 + 8
        np.testing.assert_array_equal(
            np.asarray(hdr.intrinsic_depth, np.float32), np.eye(4).ravel() * 3)

    def test_library_lives_in_build_and_hashes_source_and_flags(self):
        path = _build.host_library_path("sens_io")
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libsens_io-") and path.suffix == ".so"
        assert "-pthread" in _build.CXX_FLAGS
        assert native.load()._name == str(path)

    def test_failed_build_raises_with_the_compiler_log(self, monkeypatch,
                                                       tmp_path):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "sens_io.cpp").write_text("this is not C++\n")
        monkeypatch.setattr(_build, "CSRC", csrc)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="g\\+\\+ exit") as e:
            _build.build_host("sens_io")
        assert "sens_io.cpp" in str(e.value)
        assert not list((tmp_path / "build").iterdir())  # no partial file

    def test_missing_compiler_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            _build.build_host("sens_io")


class TestNativeColmap:
    def test_images_bin_native_matches_python_and_jax(
            self, tmp_path, jax_python_readers):
        images = _images()
        _write_images_bin(tmp_path / "images.bin", images)
        path = str(tmp_path / "images.bin")
        got_native = colmap_io.read_images_bin(path)
        got_py = colmap_io.read_images_bin_plain(path)
        _same_images(got_native, got_py)
        _same_images(got_native, jcolmap.read_images_bin(path))
        # read_images(workspace) reads .bin through the native path
        _same_images(colmap_io.read_images(str(tmp_path)), got_py)

    def test_malformed_images_bin_raises_colmap_error(self, tmp_path):
        _write_images_bin(tmp_path / "images.bin", _images())
        data = (tmp_path / "images.bin").read_bytes()
        (tmp_path / "images.bin").write_bytes(data[:-60])
        with pytest.raises(colmap_io.ColmapError, match="images.bin"):
            colmap_io.read_images_bin(str(tmp_path / "images.bin"))


class TestSensExporters:
    def test_exporters_roundtrip(self, tmp_path):
        imageio = pytest.importorskip("imageio.v2")

        rng = np.random.default_rng(3)
        H, W = 16, 24
        frames = []
        depths = []
        for i in range(3):
            depth = rng.integers(0, 5000, (H, W)).astype("<u2")
            depths.append(depth)
            color = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
            buf = _io.BytesIO()
            imageio.imwrite(buf, color, format="jpeg")
            frames.append(dict(
                camera_to_world=np.eye(4) + i * 0.125,
                timestamp_color=i, timestamp_depth=i,
                color_data=buf.getvalue(),
                depth_data=zlib.compress(depth.tobytes()),
            ))
        path = tmp_path / "s.sens"
        scannet.write_sens(str(path), "x", np.eye(4), np.eye(4), np.eye(4),
                           np.eye(4), (H, W), (H, W), 1000.0, frames)
        s = SensFile(str(path))

        s.export_depth_images(str(tmp_path / "d"))
        s.export_color_images(str(tmp_path / "c"))
        s.export_poses(str(tmp_path / "p"))
        s.export_intrinsics(str(tmp_path / "i"))
        assert sorted(os.listdir(tmp_path / "d")) == ["0.png", "1.png",
                                                       "2.png"]
        got = imageio.imread(tmp_path / "d" / "1.png")
        np.testing.assert_array_equal(got, depths[1])
        pose = np.loadtxt(tmp_path / "p" / "2.txt")
        np.testing.assert_allclose(pose, np.eye(4) + 2 * 0.125, atol=1e-6)
        assert (tmp_path / "i" / "intrinsic_color.txt").exists()
        color = imageio.imread(tmp_path / "c" / "0.jpg")
        assert color.shape == (H, W, 3)
        # batch depth decode equals per-frame decode
        batch = s.decode_all_depths()
        np.testing.assert_array_equal(batch, np.stack(depths))
        assert s.depth_image(s.frames[2]).dtype == np.dtype("<u2")

    @pytest.mark.parametrize("max_frames", [None, 5])
    def test_native_equals_plain_equals_jax(self, tmp_path, max_frames,
                                            jax_python_readers):
        """Shuffled timestamps: every reader sorts by colour timestamp;
        the native batch decode equals the plain one and JAX's."""
        rng = np.random.default_rng(11)
        hw = (12, 20)
        frames, depths = _sens_frames(rng, 9, hw, shuffle=True)
        path = str(_write(tmp_path / "s.sens", frames, hw))
        nat = SensFile(path, max_frames=max_frames)
        plain = SensFile.plain(path, max_frames=max_frames)
        ref = jscannet.SensFile(path, max_frames=max_frames)
        assert getattr(ref, "_records", None) is None  # JAX's python path
        assert nat._records is not None and not hasattr(plain, "_records")
        _same_sens(nat, plain)
        _same_sens(nat, ref)
        n = len(frames) if max_frames is None else max_frames
        assert len(nat.frames) == n
        ts = [fr.timestamp_color for fr in nat.frames]
        assert ts == sorted(ts)
        batch = nat.decode_all_depths()
        assert batch.dtype == np.uint16 and batch.shape == (n,) + hw
        np.testing.assert_array_equal(batch, plain.decode_all_depths())
        np.testing.assert_array_equal(batch, ref.decode_all_depths())
        order = np.argsort([f["timestamp_color"] for f in frames[:n]])
        np.testing.assert_array_equal(batch, np.stack(depths[:n])[order])

    def test_indexed_frames_share_the_file_buffer(self, tmp_path):
        frames, _ = _sens_frames(np.random.default_rng(1), 4, (6, 8))
        s = SensFile(str(_write(tmp_path / "z.sens", frames)))
        assert all(fr._buf is s._buf for fr in s.frames)
        assert all(isinstance(fr, scannet._IndexedFrame) for fr in s.frames)


class TestNativeSensRobustness:
    def _one_frame_sens(self, tmp_path, name="w.sens"):
        frames = [dict(camera_to_world=np.eye(4), timestamp_color=0,
                       timestamp_depth=0, color_data=b"x" * 100,
                       depth_data=zlib.compress(b"\x00" * 200))]
        path = tmp_path / name
        scannet.write_sens(str(path), "x", np.eye(4), np.eye(4), np.eye(4),
                           np.eye(4), (10, 10), (10, 10), 1000.0, frames)
        return path

    @pytest.mark.parametrize("plain", [False, True])
    def test_truncated_sens_raises(self, tmp_path, plain):
        data = self._one_frame_sens(tmp_path, "t.sens").read_bytes()
        bad = tmp_path / "bad.sens"
        bad.write_bytes(data[:-50])  # cut into the last frame payload
        with pytest.raises(scannet.SensError):
            (SensFile.plain if plain else SensFile)(str(bad))

    @pytest.mark.parametrize("plain", [False, True])
    def test_wrong_version_raises(self, tmp_path, plain):
        path = tmp_path / "v9.sens"
        path.write_bytes(struct.pack("<I", 9) + b"\x00" * 64)
        with pytest.raises(ValueError):
            (SensFile.plain if plain else SensFile)(str(path))

    def test_wrapping_color_size_rejected(self, tmp_path):
        """A color_size near UINT64_MAX must be a parse error, not a
        uint64 wraparound that leaves out-of-range payload offsets for the
        zlib batch decoder (OOB read)."""
        path = self._one_frame_sens(tmp_path)
        data = bytearray(path.read_bytes())
        hdr = native.parse_header(bytes(data))
        # frame record: 64B pose + 8 ts_color + 8 ts_depth, then color_size
        off = int(hdr.frames_start) + 64 + 16
        data[off:off + 8] = b"\xff" * 8
        with pytest.raises(ValueError):
            native.index_frames(bytes(data), int(hdr.frames_start), 1)

    def test_huge_num_frames_rejected(self, tmp_path):
        """A corrupt num_frames must raise, not allocate multi-GB records."""
        data = self._one_frame_sens(tmp_path).read_bytes()
        hdr = native.parse_header(data)
        with pytest.raises(ValueError):
            native.index_frames(data, int(hdr.frames_start), 2**40)

    def test_decode_depth_oob_spans_rejected(self):
        data = b"\x00" * 64
        with pytest.raises(ValueError):
            native.decode_depth_batch(
                data, np.array([2**63], np.uint64),
                np.array([100], np.uint64), 100,
            )
        with pytest.raises(ValueError):
            native.decode_depth_batch(
                data, np.array([32], np.uint64),
                np.array([64], np.uint64), 100,  # 32 + 64 > 64
            )

    def test_depth_batch_reports_the_lowest_failing_frame(self):
        """The workers inflate frames in any order; the error names the
        lowest failing one, as the OpenMP loop of the JAX package does."""
        pixels = 64
        good = zlib.compress(np.arange(pixels, dtype="<u2").tobytes())
        blobs = [good] * 40
        for bad in (31, 7, 19):
            blobs[bad] = b"\x78\x9c corrupt"
        data = b"".join(blobs)
        sizes = np.array([len(b) for b in blobs], np.uint64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.uint64)
        with pytest.raises(ValueError, match="at frame 7$"):
            native.decode_depth_batch(data, offsets, sizes, pixels)
        ok = [i for i in range(40) if i not in (31, 7, 19)]
        out = native.decode_depth_batch(data, offsets[ok], sizes[ok], pixels)
        assert (out == np.arange(pixels)).all() and out.shape == (37, 64)

    def test_corrupt_depth_blob_raises_sens_error(self, tmp_path):
        frames = [dict(camera_to_world=np.eye(4), timestamp_color=0,
                       timestamp_depth=0, color_data=b"x",
                       depth_data=b"not zlib at all")]
        path = _write(tmp_path / "c.sens", frames)
        with pytest.raises(scannet.SensError, match="frame 0"):
            SensFile(str(path)).decode_all_depths()


class TestNativeColmapRobustness:
    def test_huge_image_count_rejected(self):
        data = np.uint64(2**40).tobytes() + b"\x00" * 80
        with pytest.raises(ValueError):
            native.index_colmap_images(data)

    def test_wrapping_npoints_rejected(self):
        rec = (
            struct.pack("<i", 1)              # image_id
            + struct.pack("<4d", 1, 0, 0, 0)  # qvec
            + struct.pack("<3d", 0, 0, 0)     # tvec
            + struct.pack("<i", 1)            # camera_id
            + b"img.png\x00"
            + struct.pack("<Q", 2**61)        # npoints: wraps *24
        )
        data = struct.pack("<Q", 1) + rec
        with pytest.raises(ValueError):
            native.index_colmap_images(data)


def _mutations(seed_bytes, n, rng_seed):
    """Deterministic byte-level mutations (tests/test_io.py's _Mutator):
    flips, truncations, appended junk, spliced segments."""
    rng = np.random.default_rng(rng_seed)
    for _ in range(n):
        data = bytearray(seed_bytes)
        op = rng.integers(0, 4)
        if op == 0 and len(data):
            for _ in range(int(rng.integers(1, 8))):
                data[rng.integers(0, len(data))] = rng.integers(0, 256)
        elif op == 1:
            data = data[: rng.integers(0, len(data) + 1)]
        elif op == 2:
            data += bytes(rng.integers(0, 256, size=int(rng.integers(1, 64)),
                                       dtype=np.uint8))
        elif len(data) > 8:
            a, b = sorted(rng.integers(0, len(data), 2))
            seg = data[a:b]
            del data[a:b]
            c = rng.integers(0, len(data) + 1)
            data[c:c] = seg
        yield bytes(data)


def _outcome(parse, allowed):
    """(True, result) or (False, error type); any other error fails."""
    try:
        return True, parse()
    except allowed as e:
        return False, type(e)


class TestSensFuzz:
    N = 150

    def _seed(self, tmp_path):
        eye = np.eye(4, dtype=np.float32)
        frames = []
        for i in range(2):
            depth = zlib.compress(
                np.full((8 * 6,), 1000, np.uint16).tobytes()
            )
            frames.append(dict(
                camera_to_world=eye, timestamp_color=i, timestamp_depth=i,
                color_data=b"\xff\xd8fakejpeg\xff\xd9", depth_data=depth,
            ))
        p = tmp_path / "seed.sens"
        scannet.write_sens(
            str(p), "sensor", eye, eye, eye, eye, (6, 8), (6, 8), 1000.0,
            frames,
        )
        return p.read_bytes()

    @pytest.mark.parametrize("use_native", [True, False])
    def test_mutations_raise_typed_errors(self, tmp_path, use_native,
                                          jax_python_readers):
        """Each reader succeeds or raises SensError (or the documented
        NotImplementedError) on every mutation; where both of the port's
        readers succeed they read the same stream, and JAX's python
        reader agrees on which inputs parse."""
        seed = self._seed(tmp_path)
        target = tmp_path / "fz.sens"
        allowed = (scannet.SensError, NotImplementedError)
        first = SensFile if use_native else SensFile.plain
        other = SensFile.plain if use_native else SensFile
        fails, parsed = [], 0
        for i, data in enumerate(_mutations(seed, self.N,
                                            5 if use_native else 6)):
            target.write_bytes(data)
            try:
                ok, got = _outcome(lambda: first(str(target)), allowed)
                ok2, got2 = _outcome(lambda: other(str(target)), allowed)
                okj, _ = _outcome(lambda: jscannet.SensFile(str(target)),
                                  (jscannet.SensError, NotImplementedError))
            except Exception as e:  # noqa: BLE001 - the assertion target
                fails.append((i, type(e).__name__, str(e)[:80]))
                continue
            if not ok == ok2 == okj:
                fails.append((i, "readers disagree", ok, ok2, okj))
            elif ok:
                parsed += 1
                # the C header keeps the name up to its first NUL byte
                _same_sens(got, got2, names="\x00" not in got2.sensor_name
                           and "\x00" not in got.sensor_name)
        assert not fails, fails[:10]
        assert parsed > 0  # the fuzz reaches successful parses too


class TestColmapImagesFuzz:
    N = 150

    def test_images_bin_mutations(self, tmp_path):
        """images.bin through the native indexer: ColmapError or a
        result on every mutation (TestColmapFuzz's images.bin case)."""
        seed = (
            struct.pack("<Q", 1)
            + struct.pack("<i", 1)
            + struct.pack("<4d", 1, 0, 0, 0)
            + struct.pack("<3d", 0, 0, 0)
            + struct.pack("<i", 1)
            + b"img0.png\x00"
            + struct.pack("<Q", 0)
        )
        ws = tmp_path / "ws"
        ws.mkdir()
        target = ws / "images.bin"
        target.write_bytes(seed)
        assert colmap_io.read_images(str(ws))[1].name == "img0.png"
        fails = []
        for i, data in enumerate(_mutations(seed, self.N, 4)):
            target.write_bytes(data)
            try:
                colmap_io.read_images(str(ws))
            except colmap_io.ColmapError:
                pass
            except Exception as e:  # noqa: BLE001 - the assertion target
                fails.append((i, type(e).__name__, str(e)[:80]))
        assert not fails, fails[:10]
