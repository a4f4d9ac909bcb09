"""The port's frame decoders (cusift_tpu_torch/utils/native_loader.py,
imgcodec.py): tests/test_native.py's cases for the numpy decoder and for
the native one (built from cusift_tpu_torch/csrc/frameloader.cpp with g++
and zlib where they exist), and the two agreeing byte for byte on every
file of the cases; the port's PNG writer read back by cv2.
"""

import struct
import zlib

import numpy as np
import pytest

from cusift_tpu_torch.utils import imgcodec, native_loader

BACKENDS = ["numpy", pytest.param("native", marks=pytest.mark.skipif(
    not native_loader.native_available(), reason="g++ or zlib.h missing: no native build"))]


def _write_pgm(path, arr, maxval=255):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n# comment\n{w} {h}\n{maxval}\n".encode())
        f.write(arr.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def _write_ppm(path, arr):
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def _luma(rgb, maxv):
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / maxv


def _files(tmp_path, rng):
    """One file of every case, for the byte-agreement check."""
    paths = {}
    img = rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    paths["pgm8"] = str(tmp_path / "a.pgm")
    _write_pgm(paths["pgm8"], img)
    paths["pgm16"] = str(tmp_path / "d.pgm")
    _write_pgm(paths["pgm16"], rng.integers(0, 30000, size=(32, 40)), maxval=65535)
    paths["ppm"] = str(tmp_path / "c.ppm")
    _write_ppm(paths["ppm"], rng.integers(0, 256, size=(24, 30, 3)))
    paths["npy"] = str(tmp_path / "x.npy")
    np.save(paths["npy"], rng.normal(size=(20, 28)).astype(np.float32))
    paths["npy16"] = str(tmp_path / "x16.npy")
    np.save(paths["npy16"], rng.integers(0, 65535, size=(9, 11)).astype(np.uint16))
    for ft in range(5):
        paths[f"png_rgb_{ft}"] = str(tmp_path / f"rgb{ft}.png")
        imgcodec.write_png(paths[f"png_rgb_{ft}"],
                           rng.integers(0, 256, size=(24, 30, 3)).astype(np.uint8), ft)
    paths["png16"] = str(tmp_path / "d.png")
    imgcodec.write_png(paths["png16"], rng.integers(0, 30000, size=(32, 40)).astype(np.uint16),
                       [y % 5 for y in range(32)])
    return paths


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_pgm8(tmp_path, rng, backend):
    img = rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, img)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), img / 255.0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_pgm16_depth(tmp_path, rng, backend):
    depth = rng.integers(0, 30000, size=(32, 40)).astype(np.uint16)
    p = str(tmp_path / "d.pgm")
    _write_pgm(p, depth, maxval=65535)
    out = native_loader.decode(p, scale=1.0 / 5000.0, backend=backend)
    np.testing.assert_allclose(out, depth / 5000.0, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_ppm_gray(tmp_path, rng, backend):
    img = rng.integers(0, 256, size=(24, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "c.ppm")
    _write_ppm(p, img)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), _luma(img, 255.0),
                               atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_ppm16(tmp_path, rng, backend):
    """16-bit P6: big-endian samples, not byte-interleaved-as-RGB garbage."""
    rgb = (rng.random((4, 6, 3)) * 65535).astype(np.uint16)
    p = tmp_path / "c16.ppm"
    p.write_bytes(b"P6\n6 4\n65535\n" + rgb.astype(">u2").tobytes())
    np.testing.assert_allclose(native_loader.decode(str(p), backend=backend),
                               _luma(rgb.astype(np.float32), 65535.0), atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_npy(tmp_path, rng, backend):
    arr = rng.normal(size=(20, 28)).astype(np.float32)
    p = str(tmp_path / "x.npy")
    np.save(p, arr)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), arr, atol=1e-7)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_npy_uint8_normalises(tmp_path, rng, backend):
    """scale == 0 normalises integer dtypes by their max."""
    img = (rng.random((8, 16)) * 255).astype(np.uint8)
    p = str(tmp_path / "u8.npy")
    np.save(p, img)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend),
                               img.astype(np.float32) / 255.0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_order_and_content(tmp_path, rng, backend):
    paths, imgs = [], []
    for i in range(12):
        img = rng.integers(0, 256, size=(16, 20)).astype(np.uint8)
        p = str(tmp_path / f"f{i:03d}.pgm")
        _write_pgm(p, img)
        paths.append(p)
        imgs.append(img / 255.0)
    stream = native_loader.FrameStream(paths, threads=3, queue_depth=4, backend=backend)
    assert stream.backend == backend
    got = list(stream)
    assert len(got) == 12
    for a, b in zip(got, imgs):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_bad_file_raises(tmp_path, backend):
    p = str(tmp_path / "bad.pgm")
    with open(p, "wb") as f:
        f.write(b"not an image")
    stream = native_loader.FrameStream([p], backend=backend)
    with pytest.raises(ValueError):
        next(stream)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png8_gray(tmp_path, rng, backend):
    img = rng.integers(0, 256, size=(48, 64)).astype(np.uint8)
    p = str(tmp_path / "a.png")
    imgcodec.write_png(p, img, 0)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), img / 255.0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png16_depth_scale(tmp_path, rng, backend):
    depth = rng.integers(0, 30000, size=(32, 40)).astype(np.uint16)
    p = str(tmp_path / "d.png")
    imgcodec.write_png(p, depth, 0)
    np.testing.assert_allclose(native_loader.decode(p, scale=1.0 / 5000.0, backend=backend),
                               depth / 5000.0, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png_rgb_to_gray(tmp_path, rng, backend):
    img = rng.integers(0, 256, size=(24, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "c.png")
    imgcodec.write_png(p, img, 1)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), _luma(img, 255.0),
                               atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png_all_filters(tmp_path, backend):
    """A smooth gradient image with every filter type, row by row."""
    yy, xx = np.mgrid[0:40, 0:52]
    img = ((np.sin(yy / 6.0) + np.cos(xx / 9.0) + 2.0) * 60).astype(np.uint8)
    p = str(tmp_path / "f.png")
    imgcodec.write_png(p, img, [y % 5 for y in range(40)])
    np.testing.assert_allclose(native_loader.decode(p, backend=backend), img / 255.0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png_cv2_oracle(tmp_path, rng, backend):
    """A cv2-encoded PNG (adaptive filters, a real zlib stream)."""
    cv2 = pytest.importorskip("cv2")
    img = (rng.random((37, 53)) * 255).astype(np.uint8)
    p = str(tmp_path / "o.png")
    assert cv2.imwrite(p, img)
    np.testing.assert_allclose(native_loader.decode(p, backend=backend),
                               cv2.imread(p, cv2.IMREAD_GRAYSCALE) / 255.0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_png_oversized_idat_rejected(tmp_path, rng, backend):
    """An IDAT inflating past the IHDR-declared size fails, not OOMs."""
    img = rng.integers(0, 256, size=(8, 8)).astype(np.uint8)
    p = tmp_path / "evil.png"
    imgcodec.write_png(str(p), img, 0)
    blob = zlib.compress(b"\x00" * (16 << 20))
    b = bytearray(p.read_bytes())
    start = b.index(b"IDAT") - 4
    end = start + 12 + struct.unpack(">I", b[start:start + 4])[0]
    b[start:end] = (struct.pack(">I", len(blob)) + b"IDAT" + blob
                    + struct.pack(">I", zlib.crc32(b"IDAT" + blob)))
    p.write_bytes(bytes(b))
    with pytest.raises(ValueError):
        native_loader.decode(str(p), backend=backend)


@pytest.mark.skipif(not native_loader.native_available(), reason="no native build")
def test_decoders_agree_byte_for_byte(tmp_path, rng):
    for name, p in _files(tmp_path, rng).items():
        for scale in (0.0, 1.0 / 5000.0):
            a = native_loader.decode(p, scale, backend="numpy")
            b = native_loader.decode(p, scale, backend="native")
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), (name, scale)


def test_png_writer_read_by_cv2(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    gray = rng.integers(0, 256, size=(21, 33)).astype(np.uint8)
    rgb = rng.integers(0, 256, size=(21, 33, 3)).astype(np.uint8)
    d16 = rng.integers(0, 65535, size=(21, 33)).astype(np.uint16)
    for ft in range(5):
        imgcodec.write_png(str(tmp_path / "g.png"), gray, ft)
        imgcodec.write_png(str(tmp_path / "c.png"), rgb, ft)
        imgcodec.write_png(str(tmp_path / "d.png"), d16, ft)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED),
                                      gray)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png"))[..., ::-1], rgb)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED),
                                      d16)


def test_decoder_names_what_runs():
    assert native_loader.decoder() == ("native" if native_loader.native_available() else "numpy")
    with pytest.raises(ValueError):
        native_loader.decode("x.png", backend="cv2")
