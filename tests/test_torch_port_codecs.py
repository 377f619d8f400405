"""The port's file codecs and OpenCV twins against OpenCV, Pillow and h5py,
on the CPU: ``data/png.py``, ``data/jpeg.py``, ``data/hdf5.py`` and
``data/cv.py``. Bits are the target; the one exception is stated where it
is tested (the float32 resizes this OpenCV build hands to Intel IPP)."""

import io
import os.path as osp
import struct
import sys
import zlib

import cv2
import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from implicit_depth_torch.data import cv, hdf5, jpeg, png
from implicit_depth_torch.data.synthetic import synthetic_scene_raw
from implicit_depth_tpu.data.seg_io import imwrite_indexed

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "scripts"))

torch.set_num_threads(2)


def smooth(rng, h, w, c, dtype=np.uint8, top=255):
    """A smooth image with a little noise: libpng picks every filter."""
    y, x = np.mgrid[:h, :w]
    base = (np.sin(x / 7.0) + np.cos(y / 5.0) + 2) / 4 * top
    img = base[..., None] + rng.integers(0, 3, (h, w, c))
    img = np.clip(img, 0, top).astype(dtype)
    return img[..., 0] if c == 1 else img


# -- PNG --------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(48, 64), (97, 131), (480, 640)])
def test_png_reads_jax_palette_masks_as_pillow_and_cv2(tmp_path, hw):
    mask = (np.random.default_rng(0).random(hw) > 0.5).astype(np.uint8) * 255
    path = str(tmp_path / "m.png")
    imwrite_indexed(path, mask)
    idx, pal = png.read_png(path, with_palette=True)
    np.testing.assert_array_equal(idx, np.array(Image.open(path)))
    np.testing.assert_array_equal(pal[idx][..., ::-1],
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(png.read_png_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "depth16",
                                  "noise"])
@pytest.mark.parametrize("hw", [(97, 131), (480, 640)])
def test_png_reads_cv2_files(tmp_path, kind, hw):
    """cv2.imwrite lets libpng choose each row's filter (0-4)."""
    rng = np.random.default_rng(1)
    img = {"grey": lambda: smooth(rng, *hw, 1),
           "rgb": lambda: smooth(rng, *hw, 3),
           "rgba": lambda: smooth(rng, *hw, 4),
           "depth16": lambda: smooth(rng, *hw, 1, np.uint16, 4000),
           "noise": lambda: rng.integers(0, 256, hw + (3,), np.uint8)}[kind]()
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    got = png.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if got.ndim == 3:  # stored RGB(A); cv2 gives BGR(A)
        got = np.concatenate([got[..., 2::-1], got[..., 3:]], -1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if img.dtype == np.uint8 and kind != "rgba":
        np.testing.assert_array_equal(png.read_png_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("kind", ["grey", "rgb", "depth16", "palette"])
def test_png_writer_reads_back_through_cv2_and_pillow(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "p.png")
    pal = None
    if kind == "palette":
        img = rng.integers(0, 3, (37, 53), dtype=np.uint8)
        pal = np.array([[0, 0, 0], [224, 224, 192], [10, 200, 30]], np.uint8)
    else:
        img = {"grey": lambda: smooth(rng, 37, 53, 1),
               "rgb": lambda: smooth(rng, 37, 53, 3),
               "depth16": lambda: smooth(rng, 37, 53, 1, np.uint16,
                                         60000)}[kind]()
    png.write_png(path, img, palette=pal)
    np.testing.assert_array_equal(np.array(Image.open(path)), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if kind == "palette":
        np.testing.assert_array_equal(back, pal[img][..., ::-1])
    elif img.ndim == 3:
        np.testing.assert_array_equal(back, img[..., ::-1])
    else:
        np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    """Every image the standard defines is read; what it does not define
    raises, naming it."""
    def write(name, depth, color, interlace, method=0):
        path = str(tmp_path / name)
        raw = zlib.compress(bytes(4 * (1 + 8)))
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
                ">IIBBBBB", 4, 4, depth, color, method, 0, interlace))
                + _png_chunk(b"IDAT", raw) + _png_chunk(b"IEND", b""))
        return path

    with pytest.raises(ValueError, match="interlace method 2"):
        png.read_png(write("i.png", 8, 0, 2))
    with pytest.raises(ValueError, match="16-bit palette PNG does not exist"):
        png.read_png(write("p16.png", 16, 3, 0))
    with pytest.raises(ValueError, match="4-bit RGB PNG does not exist"):
        png.read_png(write("r4.png", 4, 2, 0))
    with pytest.raises(ValueError, match="compression method 1"):
        png.read_png(write("c1.png", 8, 0, 0, method=1))
    with pytest.raises(ValueError, match="colour type 5"):
        png.read_png(write("t5.png", 8, 5, 0))


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _png_rows(img, depth, ch):
    """(h, w[, ch]) samples -> (h, stride) bytes, fields MSB first."""
    h, w = img.shape[:2]
    s = img.reshape(h, w * ch).astype(np.uint32)
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    per = 8 // depth
    s = np.concatenate([s, np.zeros((h, -(w * ch) % per), np.uint32)], 1)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (s.reshape(h, -1, per) << shifts).sum(2).astype(np.uint8)


def _png_filtered(rows, bpp):
    """Each row behind a filter byte, the filters 0-4 in turn."""
    h, stride = rows.shape
    out = np.zeros((h, stride + 1), np.uint8)
    b = np.zeros(stride, np.int64)
    for r in range(h):
        x = rows[r].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x])[:stride]
        c = np.concatenate([np.zeros(bpp, np.int64), b])[:stride]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][r % 5]
        out[r, 0], out[r, 1:] = r % 5, (x - pred) & 255
        b = x
    return out


def write_png_any(path, img, depth, color, interlace, palette=None):
    """Any PNG the standard defines (the writers at hand write none of the
    interlaced, 2- and 4-bit grey or 16-bit grey + alpha images), its rows
    behind every filter in turn, its data in two IDAT chunks."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, ch * depth // 8)
    h, w = img.shape[:2]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(
        _png_filtered(_png_rows(img[r0::dr, c0::dc], depth, ch), bpp).tobytes()
        for r0, c0, dr, dc in passes if r0 < h and c0 < w)
    z = zlib.compress(raw, 9)
    parts = [b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(_png_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    parts += [_png_chunk(b"IDAT", z[:len(z) // 2]),
              _png_chunk(b"IDAT", z[len(z) // 2:]), _png_chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def assert_png_read_as_pillow_and_cv2(path, stored=None):
    """The port's three views of a PNG against Pillow's and cv2's reads at
    the JAX call sites (and the stored samples, when given)."""
    want = np.array(Image.open(path))
    got = png.read_png_pillow(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_png_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.read_png_rgb(path), cv2.cvtColor(
        cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    if stored is not None:
        np.testing.assert_array_equal(png.read_png(path), stored)


PNG_KINDS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (1, 3), (2, 3), (4, 3),
             (8, 3), (8, 4), (16, 4), (8, 2), (16, 2), (8, 6), (16, 6)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,color", PNG_KINDS)
def test_png_reads_every_kind_as_pillow_and_cv2(tmp_path, depth, color,
                                                interlace):
    """Every colour type at every bit depth, plain and Adam7-interlaced, at
    sizes whose rows end inside a byte and whose interlace passes are
    ragged or empty (3x5), each row behind another filter."""
    rng = np.random.default_rng(depth * 10 + color)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((37, 29), (3, 5)):
        img = rng.integers(0, 1 << depth, (h, w, ch)).astype(
            np.uint16 if depth == 16 else np.uint8)
        img = img[..., 0] if ch == 1 else img
        pal = rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None
        path = str(tmp_path / f"{h}x{w}.png")
        write_png_any(path, img, depth, color, interlace, pal)
        assert_png_read_as_pillow_and_cv2(path, stored=img)


@pytest.mark.parametrize("kind", ["pillow 1-bit", "pillow palette 1-bit",
                                  "pillow palette 2-bit",
                                  "pillow palette 4-bit", "cv2 16-bit RGB",
                                  "cv2 16-bit RGBA"])
def test_png_reads_pillow_and_cv2_low_bit_and_16_bit_files(tmp_path, kind):
    """The 1-, 2- and 4-bit files Pillow writes and the 16-bit colour files
    cv2 writes, each row's filter chosen by the writer."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "x.png")
    if kind == "pillow 1-bit":
        Image.fromarray(smooth(rng, 97, 131, 1) > 128).save(path)
    elif kind.startswith("pillow palette"):
        bits = int(kind.split()[-1][0])
        im = Image.fromarray((smooth(rng, 97, 131, 1) >> (8 - bits)).astype(
            np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 << bits).tolist())
        im.save(path, bits=bits)
        assert Image.open(path).info.get("bits", bits) == bits
    else:
        ch = 3 if kind.endswith("RGB") else 4
        cv2.imwrite(path, smooth(rng, 97, 131, ch, np.uint16, 65535))
    with open(path, "rb") as f:
        depth = f.read(25)[24]
    assert depth == {"pillow 1-bit": 1}.get(
        kind, 16 if kind.startswith("cv2") else int(kind.split()[-1][0]))
    assert_png_read_as_pillow_and_cv2(path)


# -- JPEG -------------------------------------------------------------------

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "grey": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def scene_bgr(h, w, seed=0):
    s = synthetic_scene_raw(np.random.default_rng(seed), max(h, 16),
                            max(w, 16))
    return np.ascontiguousarray(s["rgb_u8"][:h, :w, ::-1])


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_decoder_gives_cv2_bits(sampling, quality, restart):
    """cv2-written files at an odd size, a noisy and a scene image."""
    rng = np.random.default_rng(quality + restart)
    for img in (np.clip(rng.normal(128, 40, (97, 131, 3)), 0, 255).astype(
            np.uint8), scene_bgr(97, 131, quality)):
        if sampling == "grey":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
        assert ok
        np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes()),
                                      cv2.imdecode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", ["420", "422", "444", "411", "grey"])
@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_decoder_gives_cv2_bits_for_progressive_files(sampling, quality,
                                                           restart):
    """cv2-written progressive files (libjpeg's simple progression: DC
    first and refine scans, AC first scans with end-of-band runs over
    spectral bands, AC refine scans) at an odd size, a noisy and a scene
    image, with and without restarts: the bits of cv2's decode."""
    rng = np.random.default_rng(quality + restart + 1)
    for img in (np.clip(rng.normal(128, 40, (97, 131, 3)), 0, 255).astype(
            np.uint8), scene_bgr(97, 131, quality)):
        if sampling == "grey":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
        assert ok and b"\xff\xc2" in buf.tobytes()
        np.testing.assert_array_equal(jpeg.decode_jpeg(buf.tobytes()),
                                      cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_jpeg_decoder_reads_progressive_loader_frames_as_cv2(tmp_path):
    """480x640 scenes written progressive, read as ``cv2.imread``."""
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, scene_bgr(480, 640, 5), [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                               1])
    np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2.imread(path))


def test_jpeg_decoder_reads_the_loader_frames_as_cv2(tmp_path):
    """480x640 scenes written as the disk datasets' JPEGs are, read as
    ``cv2.imread`` reads them."""
    for seed in range(2):
        path = str(tmp_path / f"{seed}.jpg")
        cv2.imwrite(path, scene_bgr(480, 640, seed))
        np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2.imread(path))


def _pillow_cmyk(bgr, **kw):
    """A CMYK JPEG as Pillow writes it (an Adobe marker of transform 0)."""
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).convert(
        "CMYK").save(out, "JPEG", **kw)
    return out.getvalue()


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2, -1])
def test_jpeg_decoder_reads_pillow_cmyk_files_as_cv2(subsampling,
                                                     progressive):
    """CMYK files (4 components, as Pillow writes them: 4:4:4, C at 2x2
    beside 1x1 planes, Pillow's default) decode to ``cv2.imdecode``'s BGR
    bits: OpenCV's conversion of inverted CMYK."""
    rng = np.random.default_rng(subsampling + 1 + 7 * progressive)
    for img in (np.clip(rng.normal(128, 40, (97, 131, 3)), 0, 255).astype(
            np.uint8), scene_bgr(97, 131, subsampling + 4)):
        data = _pillow_cmyk(img, quality=90, subsampling=subsampling,
                            progressive=progressive)
        sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
        assert data[sof + 9] == 4 and b"Adobe" in data
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(data),
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def test_jpeg_decoder_refuses_other_modes(tmp_path):
    """Arithmetic coding (sequential and progressive), lossless and
    hierarchical files, 12-bit samples and YCCK raise, naming them."""
    img = scene_bgr(32, 48)
    data = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    sof = data.index(b"\xff\xc0")
    arith = bytes(data[:sof + 1]) + b"\xc9" + bytes(data[sof + 2:])
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(arith)
    for marker, kind in ((b"\xc3", "lossless"),
                         (b"\xc5", "hierarchical sequential")):
        with pytest.raises(ValueError, match=kind):
            jpeg.decode_jpeg(bytes(data[:sof + 1]) + marker
                             + bytes(data[sof + 2:]))
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    prog = bytearray(prog.tobytes())
    sof2 = prog.index(b"\xff\xc2")
    prog[sof2 + 1] = 0xCA
    with pytest.raises(ValueError, match="arithmetic-coded progressive"):
        jpeg.decode_jpeg(bytes(prog))
    twelve = bytes(data[:sof + 4]) + b"\x0c" + bytes(data[sof + 5:])
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(twelve)
    cmyk = bytearray(_pillow_cmyk(img))
    adobe = cmyk.index(b"Adobe")
    assert cmyk[adobe + 11] == 0  # the transform: none (CMYK)
    cmyk[adobe + 11] = 2          # YCCK
    with pytest.raises(ValueError, match="YCCK"):
        jpeg.decode_jpeg(bytes(cmyk))


def psnr(a, b):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / err)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("hw", [(480, 640), (97, 131)])
def test_jpeg_encoder_files_decode_alike_and_keep_cv2_quality(hw, seed):
    """cv2 and the port decode the encoder's files to the same bits, which
    lie no further from the source than cv2's own quality-95 encode, plus
    1 dB of PSNR."""
    src = scene_bgr(*hw, seed=seed)
    data = jpeg.encode_jpeg(src)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    ours = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(ours, theirs)
    ok, ref = cv2.imencode(".jpg", src)  # quality 95, 4:2:0
    ref = cv2.imdecode(ref, cv2.IMREAD_UNCHANGED)
    assert psnr(ours, src) >= psnr(ref, src) - 1.0


# -- HDF5 -------------------------------------------------------------------

def _h5py_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
    return out


def test_hdf5_reads_jax_omniverse_files_as_h5py(tmp_path):
    from make_disk_datasets import write_omniverse
    write_omniverse(str(tmp_path), 3, np.random.default_rng(0), (48, 64))
    paths = sorted((tmp_path / "batch0").glob("*.h5"))
    assert len(paths) == 3
    for p in paths:
        got, want = hdf5.read_hdf5(str(p)), _h5py_tree(str(p))
        assert sorted(got) == sorted(want)
        assert "camera/focal_length" in got
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hdf5_writer_reads_back_through_h5py(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"rgb_glass": rng.integers(0, 255, (48, 64, 3), np.uint8),
              "depth": rng.random((48, 64)).astype(np.float32),
              "camera/pose": np.eye(4, dtype=np.float32),
              "camera/focal_length": np.asarray([24.0], np.float32),
              "i16": np.arange(-5, 5, dtype=np.int16),
              "u32": np.arange(3, dtype=np.uint32),
              "f64": np.linspace(0, 1, 7), "f16": np.ones(3, np.float16),
              "scalar": np.float32(3.5), "empty": np.zeros((0, 3), np.float32),
              **{f"many/x{i:02d}": np.full(i + 1, i, np.int64)
                 for i in range(20)}}
    path = str(tmp_path / "w.h5")
    hdf5.write_hdf5(path, arrays)
    for got in (_h5py_tree(path), hdf5.read_hdf5(path)):
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_hdf5_reads_compact_and_refuses_other_storage(tmp_path):
    """Compact storage is read; what stays refused raises when it is asked
    for, naming it: the szip filter, compound and string types, external
    and virtual storage."""
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT16,
                             h5py.h5s.create_simple((10,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(10, dtype=np.int16))
    np.testing.assert_array_equal(hdf5.read_hdf5(path)["compact"],
                                  np.arange(10))
    refused = {"szip": ({"compression": "szip"}, "filter szip"),
               "cmp": ({"data": np.zeros(3, [("a", "<i4"), ("b", "<f4")])},
                       "compound datatype"),
               "str": ({"data": np.array([b"ab", b"cd"])},
                       "string datatype"),
               "ext": ({"external": [(str(tmp_path / "raw.bin"), 0,
                                      64 * 64 * 4)]},
                       "external data files")}
    for tag, (kw, match) in refused.items():
        with h5py.File(str(tmp_path / f"{tag}.h5"), "w") as f:
            f.create_dataset("x", **({"data": np.ones((64, 64), np.float32)}
                                     | kw))
        with pytest.raises(ValueError, match=match):
            hdf5.read_hdf5(str(tmp_path / f"{tag}.h5"))
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["src"] = np.arange(3.0)
        layout = h5py.VirtualLayout(shape=(2, 3), dtype="f8")
        layout[0] = layout[1] = h5py.VirtualSource(f["src"])
        f.create_virtual_dataset("v", layout)
    np.testing.assert_array_equal(hdf5.read_hdf5(path, ["src"])["src"],
                                  np.arange(3.0))
    with pytest.raises(ValueError, match="virtual dataset storage"):
        hdf5.read_hdf5(path, ["v"])


def test_hdf5_decodes_only_the_datasets_asked_for(tmp_path):
    """A dataset that is not read (a string, an szip one) refuses the file
    only when it is asked for; a name the file lacks is a KeyError."""
    path = str(tmp_path / "n.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["a"] = np.arange(6.0).reshape(2, 3)
        f["g/label"] = np.array([b"glass", b"cup"])
        f.create_dataset("g/z", data=np.ones((64, 64), np.float32),
                         compression="szip")
        f["g/b"] = np.arange(4, dtype=np.int16)
    got = hdf5.read_hdf5(path, ["a", "g/b"])
    assert sorted(got) == ["a", "g/b"]
    np.testing.assert_array_equal(got["g/b"], np.arange(4))
    for name, match in (("g/label", "string datatype"),
                        ("g/z", "filter szip"), (None, "string datatype")):
        with pytest.raises(ValueError, match=match):
            hdf5.read_hdf5(path, None if name is None else [name])
    with pytest.raises(KeyError, match="nothing"):
        hdf5.read_hdf5(path, ["a", "nothing"])


def _zoo(rng):
    """One array of each kind the reader takes: little- and big-endian
    integers and floats, h5py's bool, at shapes chunks do not divide."""
    return {"f4": rng.random((101, 75)).astype(np.float32),
            "u8": rng.integers(0, 255, (50, 61, 3), np.uint8),
            "i2": rng.integers(-900, 900, (33, 17), np.int16),
            "be_f8": rng.random((37, 29)).astype(">f8"),
            "be_i4": rng.integers(-5, 5, (23, 41)).astype(">i4"),
            "bool": rng.random((70, 9)) > 0.5}


def assert_reads_as_h5py(path):
    got, want = hdf5.read_hdf5(path), _h5py_tree(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


HDF5_FORMATS = {"latest": {"libver": "latest"},
                "track_order": {"track_order": True},
                "latest, track_order": {"libver": "latest",
                                        "track_order": True}}


@pytest.mark.parametrize("members", [3, 9, 40, 300])
@pytest.mark.parametrize("fmt", list(HDF5_FORMATS))
def test_hdf5_reads_the_newer_file_formats_as_h5py(tmp_path, monkeypatch,
                                                   fmt, members):
    """Files of h5py's ``libver='latest'`` (superblock 3, version 2 object
    headers, link messages, the version 4 layout) and of
    ``track_order=True``: every kind of dataset, contiguous, compact and
    chunked, in nested groups, and a group of ``members`` links: past 8
    they are stored dense, in a fractal heap (an indirect block of
    several rows at 40 and 300) under a version 2 B-tree of their names'
    hashes."""
    path = str(tmp_path / "n.h5")
    with h5py.File(path, "w", **HDF5_FORMATS[fmt]) as f:
        for k, v in _zoo(np.random.default_rng(members)).items():
            f[k] = v
        f.create_dataset("camera/inner/gz", data=np.arange(700.0),
                         compression="gzip", chunks=(64,))
        g = f.create_group("many",
                           track_order=HDF5_FORMATS[fmt].get("track_order"))
        for i in range(members):
            g[f"m{i:03d}_{'x' * (i % 7)}"] = np.full(i % 5 + 1, i, np.int32)
    with open(path, "rb") as fh:
        head = fh.read(9)
    assert head[8] == (3 if "latest" in fmt else 0)
    fetched = []
    heap_object = hdf5._Reader.heap_object
    monkeypatch.setattr(hdf5._Reader, "heap_object", lambda self, a, hid: (
        fetched.append(a), heap_object(self, a, hid))[1])
    assert len(assert_reads_as_h5py(path)) == 7 + members
    assert len(fetched) == (members if members > 8 else 0)


def _chunks_for(shape, chunks):
    """``chunks`` with whole trailing axes, at most the shape (h5py's
    rule); "whole": one chunk."""
    if chunks == "whole":
        return shape
    return tuple(min(c, n) for c, n in zip(
        chunks + shape[len(chunks):], shape))


def _layout(path, name):
    r, found = hdf5._datasets(path)
    return next(b for t, _, b in r.messages(found[name]) if t == 0x08)


def _index_type(path, name):
    lay = _layout(path, name)
    assert lay[:2] == b"\x04\x02", lay[:2]  # version 4, chunked
    return lay[5 + lay[3] * lay[4]]


# the chunk indexes of the version 4 layout, by h5py's settings: (chunks,
# the axes made unlimited, other settings, the index type h5py picks)
HDF5_INDEXES = {
    "single chunk": ("whole", (), {}, 1),
    "single chunk, filtered": ("whole", (), {"compression": "gzip"}, 1),
    "fixed array": ((16, 16), (), {}, 3),
    "fixed array, filtered": ((16, 16), (), {
        "compression": "gzip", "shuffle": True, "fletcher32": True}, 3),
    "fixed array, paged": ((2, 1), (), {}, 3),
    "fixed array, paged, filtered": ((2, 1), (), {"compression": "gzip"}, 3),
    "extensible array": ((16, 16), (0,), {}, 4),
    "extensible array, second axis": ((16, 8), (1,), {}, 4),
    "extensible array, filtered": ((4, 16), (0,), {
        "compression": "gzip", "fletcher32": True}, 4),
    "version 2 B-tree": ((16, 16), (0, 1), {}, 5),
    "version 2 B-tree, filtered": ((4, 4), (0, 1), {
        "compression": "gzip", "shuffle": True}, 5),
}


@pytest.mark.parametrize("kind", list(HDF5_INDEXES))
def test_hdf5_reads_every_chunk_index_as_h5py(tmp_path, kind):
    """Every dataset kind, chunked under each index of the version 4
    layout (``libver='latest'``), with edge chunks, and a dataset most of
    whose chunks were never written (the fill value; under an extensible
    array or a B-tree, grown past what was written)."""
    chunks, unlimited, kw, index = HDF5_INDEXES[kind]
    path = str(tmp_path / "k.h5")
    with h5py.File(path, "w", libver="latest") as f:
        for name, a in _zoo(np.random.default_rng(len(kind))).items():
            f.create_dataset(name, data=a, chunks=_chunks_for(a.shape, chunks),
                             maxshape=tuple(None if i in unlimited else n
                                            for i, n in enumerate(a.shape)),
                             **kw)
        part = f.create_dataset(
            "part", shape=(64, 70), dtype=np.float32, fillvalue=-2.5,
            chunks=_chunks_for((64, 70), chunks), maxshape=tuple(
                None if i in unlimited else n
                for i, n in enumerate((64, 70))), **kw)
        part[5:20, 40:50] = 1.0
        if unlimited:
            part.resize(tuple(n + 9 if i in unlimited else n
                              for i, n in enumerate(part.shape)))
    for name in ("f4", "u8", "part"):
        assert _index_type(path, name) == index, name
    got = assert_reads_as_h5py(path)
    assert (got["part"] == -2.5).mean() > 0.9


def test_hdf5_reads_the_implicit_chunk_index_as_h5py(tmp_path):
    """Chunks allocated when the dataset is made, without filters or
    unlimited axes: the implicit index (every chunk, in order)."""
    path = str(tmp_path / "i.h5")
    rng = np.random.default_rng(5)
    arrays = {b"f4": (rng.random((101, 75)).astype(np.float32),
                      h5py.h5t.IEEE_F32LE),
              b"be_i4": (rng.integers(-9, 9, (23, 41)).astype(">i4"),
                         h5py.h5t.STD_I32BE)}
    with h5py.File(path, "w", libver="latest") as f:
        for name, (a, ftype) in arrays.items():
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((16, 16))
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            ds = h5py.h5d.create(f.id, name, ftype,
                                 h5py.h5s.create_simple(a.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a)
    assert _index_type(path, "f4") == 2
    assert_reads_as_h5py(path)


def _nbit_dataset(f, name, base, precision, offset, rng):
    """An integer dataset of ``precision`` bits from bit ``offset`` of
    ``base``, through the n-bit filter."""
    ftype = base.copy()
    ftype.set_precision(precision)
    ftype.set_offset(offset)
    signed = base.get_sign() == h5py.h5t.SGN_2
    lo, hi = ((-(1 << precision - 1), 1 << precision - 1) if signed
              else (0, 1 << precision))
    a = rng.integers(lo, hi, (33, 17)).astype(
        f"{'i' if signed else 'u'}{base.get_size()}")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((8, 8))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    ds = h5py.h5d.create(f.id, name.encode(), ftype,
                         h5py.h5s.create_simple(a.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a)


def _write_filtered(f, kind, rng):
    if kind == "lzf":
        for name, a in _zoo(rng).items():
            f.create_dataset(name, data=a, compression="lzf")
            f.create_dataset(f"s_{name}", data=a, compression="lzf",
                             shuffle=True, fletcher32=True, chunks=_chunks_for(
                                 a.shape, (8, 8)))
        f.create_dataset("zeros", data=np.zeros((300, 40), np.float32),
                         compression="lzf")
    elif kind == "scale-offset, integers":
        so = {"i2": (rng.integers(-900, 900, (33, 17)).astype(np.int16), 0),
              "i4 9 bits": (rng.integers(0, 100, (33, 17)).astype(np.int32),
                            9),
              "u2": (rng.integers(0, 3000, (33, 17)).astype(np.uint16), 0),
              "u1": (rng.integers(0, 100, (33, 17)).astype(np.uint8), 0),
              "i8": (rng.integers(-2 ** 40, 2 ** 40, (33, 17)), 0),
              "be_i4": (rng.integers(-900, 900, (33, 17)).astype(">i4"), 0),
              "constant": (np.full((33, 17), 5, np.int32), 0)}
        for name, (a, bits) in so.items():
            f.create_dataset(name, data=a, chunks=(8, 8), scaleoffset=bits)
        part = f.create_dataset("part", shape=(40, 30), dtype=np.int16,
                                fillvalue=7, chunks=(8, 8), scaleoffset=0)
        part[3:20, 4:9] = rng.integers(-50, 50, (17, 5))
    elif kind == "scale-offset, floats":
        so = {"f4": (rng.random((101, 75)).astype(np.float32), 3),
              "f8": (rng.random((40, 30)) * 100, 4),
              "be_f8": (rng.normal(0, 5, (40, 30)).astype(">f8"), 2),
              "constant": (np.full((20, 20), 2.5, np.float32), 2)}
        for name, (a, digits) in so.items():
            f.create_dataset(name, data=a, chunks=(16, 16),
                             scaleoffset=digits)
        part = f.create_dataset("part", shape=(40, 30), dtype=np.float32,
                                fillvalue=-2.5, chunks=(8, 8), scaleoffset=3)
        part[3:20, 4:9] = rng.random((17, 5))
    else:  # n-bit
        for i, (base, precision, offset) in enumerate((
                (h5py.h5t.STD_I16LE, 12, 0), (h5py.h5t.STD_I32LE, 24, 4),
                (h5py.h5t.STD_U32BE, 20, 3), (h5py.h5t.STD_U8LE, 7, 0),
                (h5py.h5t.STD_I64LE, 40, 8))):
            _nbit_dataset(f, f"n{i}", base, precision, offset, rng)
        # a type with no unused bits: the filter stores it as it is
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((16, 16))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        ds = h5py.h5d.create(f.id, b"f4", h5py.h5t.IEEE_F32LE,
                             h5py.h5s.create_simple((101, 75)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 rng.random((101, 75)).astype(np.float32))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("kind", ["lzf", "scale-offset, integers",
                                  "scale-offset, floats", "n-bit"])
def test_hdf5_reads_h5py_other_filters_as_h5py(tmp_path, kind, libver):
    """h5py's lzf (alone, and with shuffle and fletcher32), scale-offset
    (integers at their minimum bits or a given number, of every size, a
    constant chunk, and chunks holding the fill value; floats decimally
    scaled) and n-bit (integers of 7-40 significant bits at bit offsets
    0-8, signed, unsigned, big-endian; a full float stored as it is),
    under both file formats' chunk indexes."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        _write_filtered(f, kind, np.random.default_rng(len(kind)))
    with h5py.File(path) as f:
        fid = {"lzf": 32000, "n-bit": h5py.h5z.FILTER_NBIT}.get(
            kind, h5py.h5z.FILTER_SCALEOFFSET)
        for name, ds in f.items():
            plist = ds.id.get_create_plist()
            assert fid in [plist.get_filter(i)[0]
                           for i in range(plist.get_nfilters())], name
    assert_reads_as_h5py(path)


@pytest.mark.parametrize("where", ["superblock", "object header"])
def test_hdf5_refuses_metadata_whose_checksum_does_not_match(tmp_path,
                                                             where):
    path = tmp_path / "m.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(12.0)
    raw = bytearray(path.read_bytes())
    if where == "superblock":
        raw[33] ^= 1  # the end-of-file address's high byte
    else:
        _, found = hdf5._datasets(str(path))
        raw[found["x"] + 12] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=f"{where} at .* checksum does not "
                       "match"):
        hdf5.read_hdf5(str(path))


HDF5_CHUNKED = {
    "chunked": {"chunks": (16, 32)},
    "gzip 1": {"compression": "gzip", "compression_opts": 1},
    "gzip 9": {"compression": "gzip", "compression_opts": 9},
    "shuffle + gzip": {"compression": "gzip", "shuffle": True},
    "fletcher32": {"fletcher32": True, "chunks": (10, 10)},
    "fletcher32 + shuffle + gzip": {"fletcher32": True, "shuffle": True,
                                    "compression": "gzip", "chunks": (8, 5)},
    "many chunks": {"chunks": (4, 4)},  # a B-tree of several levels
}


@pytest.mark.parametrize("kind", list(HDF5_CHUNKED))
def test_hdf5_reads_chunked_and_filtered_datasets_as_h5py(tmp_path, kind):
    """Each dataset h5py writes with these storage settings, at shapes its
    chunks do not divide (edge chunks), of every type the reader takes:
    little- and big-endian integers and floats, h5py's bool; and a dataset
    most of whose chunks were never written (the fill value)."""
    rng = np.random.default_rng(len(kind))
    arrays = {"f4": rng.random((101, 75)).astype(np.float32),
              "u8": rng.integers(0, 255, (50, 61, 3), np.uint8),
              "i2": rng.integers(-900, 900, (33, 17), np.int16),
              "be_f8": rng.random((37, 29)).astype(">f8"),
              "be_i4": rng.integers(-5, 5, (23, 41)).astype(">i4"),
              "bool": rng.random((70, 9)) > 0.5}
    kw = dict(HDF5_CHUNKED[kind])
    path = str(tmp_path / "k.h5")
    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            chunks = kw.get("chunks")
            if chunks:  # at most the shape (h5py's rule), whole trailing axes
                chunks = tuple(min(c, n) for c, n in zip(
                    chunks + a.shape[len(chunks):], a.shape))
            f.create_dataset(name, data=a, **{**kw, "chunks": chunks or True})
        part = f.create_dataset("part", shape=(64, 70), dtype=np.float32,
                                fillvalue=-2.5, **{**kw, "chunks": (16, 16)})
        part[5:20, 40:50] = 1.0
        assert f["f4"].chunks is not None
    got, want = hdf5.read_hdf5(path), _h5py_tree(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["part"] == -2.5).mean() > 0.9


def test_hdf5_refuses_a_chunk_whose_checksum_does_not_match(tmp_path):
    path = tmp_path / "f.h5"
    data = np.arange(400, dtype=np.float32).reshape(20, 20)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(20, 20), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = raw.index(data[7].tobytes())
    raw[at] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32 checksum"):
        hdf5.read_hdf5(str(path))


def test_gzip_omniverse_files_load_as_the_jax_package_loads_them(tmp_path):
    """An Omniverse tree whose files h5py wrote chunked through the filters
    (gzip; gzip with shuffle; gzip with fletcher32): read_hdf5 gives
    h5py's arrays, and the port's dataset gives the JAX package's samples
    (augmented train samples' xyz_corrupt within the INTER_CUBIC bound of
    test_torch_port_data.py, as test_torch_port_disk.py holds them)."""
    from make_disk_datasets import write_omniverse
    from test_torch_port_data import assert_samples_equal

    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.data import datasets as port_ds
    from implicit_depth_tpu.config import load_config as jax_load_config
    from implicit_depth_tpu.data import datasets as jax_ds

    root = tmp_path / "omniverse"
    write_omniverse(str(root / "train"), 6, np.random.default_rng(0),
                    (48, 64))
    filters = ({}, {"shuffle": True}, {"fletcher32": True}) * 2
    paths = sorted((root / "train" / "batch0").glob("*.h5"))
    for p, kw in zip(paths, filters):
        arrays = _h5py_tree(str(p))
        with h5py.File(p, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v, compression="gzip", **kw)
        with h5py.File(p) as f:
            assert f["rgb_glass"].compression == "gzip"
        got, want = hdf5.read_hdf5(str(p)), _h5py_tree(str(p))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ov = {"dataset": {"type": "omniverse", "omniverse_root_dir": str(root),
                      "img_width": 64, "img_height": 48,
                      "use_data_augmentation": True, "depth_aug": True}}
    ds = port_ds.get_dataset(load_config(overrides=ov).dataset, "train",
                             "known", base_seed=3)
    jds = jax_ds.get_dataset(jax_load_config(overrides=ov).dataset, "train",
                             "known", base_seed=3)
    assert len(ds) == len(jds) >= 3  # the train split's share of the 6
    for idx in range(len(ds)):
        assert_samples_equal(ds.__getitem__(idx, 1), jds.__getitem__(idx, 1),
                             {"xyz_corrupt"})


def test_latest_omniverse_files_load_as_the_jax_package_loads_them(tmp_path):
    """An Omniverse tree whose files h5py rewrote with ``libver='latest'``
    (chunked datasets under the version 4 layout's indexes), each
    beside datasets the loader never reads: a scale-offset one, and a
    string and an szip one that the port does not decode. The port's
    samples are the JAX package's (augmented train samples' xyz_corrupt
    within the INTER_CUBIC bound, as above); read whole, the file
    refuses."""
    from make_disk_datasets import write_omniverse
    from test_torch_port_data import assert_samples_equal

    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.data import datasets as port_ds
    from implicit_depth_tpu.config import load_config as jax_load_config
    from implicit_depth_tpu.data import datasets as jax_ds

    root = tmp_path / "omniverse"
    write_omniverse(str(root / "train"), 4, np.random.default_rng(1),
                    (48, 64))
    rng = np.random.default_rng(2)
    paths = sorted((root / "train" / "batch0").glob("*.h5"))
    for p in paths:
        arrays = _h5py_tree(str(p))
        with h5py.File(p, "w", libver="latest") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v, chunks=True if v.size > 64
                                 else None)
            f.create_dataset("extra/scaled", data=rng.random((48, 64)),
                             chunks=(16, 16), scaleoffset=3)
            f["extra/label"] = np.array([b"glass", b"cup"])
            f.create_dataset("extra/szip", data=np.ones((64, 64), np.float32),
                             compression="szip")
        with open(p, "rb") as fh:
            assert fh.read(9)[8] == 3
        got = hdf5.read_hdf5(str(p), port_ds.OMNIVERSE_KEYS)
        for k in port_ds.OMNIVERSE_KEYS:
            assert got[k].dtype == arrays[k].dtype, k
            np.testing.assert_array_equal(got[k], arrays[k], err_msg=k)
        with pytest.raises(ValueError, match="string datatype"):
            hdf5.read_hdf5(str(p))
    for aug in (True, False):
        ov = {"dataset": {"type": "omniverse", "omniverse_root_dir": str(root),
                          "img_width": 64, "img_height": 48,
                          "use_data_augmentation": aug, "depth_aug": aug}}
        ds = port_ds.get_dataset(load_config(overrides=ov).dataset, "train",
                                 "known", base_seed=3)
        jds = jax_ds.get_dataset(jax_load_config(overrides=ov).dataset,
                                 "train", "known", base_seed=3)
        assert len(ds) == len(jds) >= 2
        for idx in range(len(ds)):
            assert_samples_equal(ds.__getitem__(idx, 1),
                                 jds.__getitem__(idx, 1), {"xyz_corrupt"})

# -- the OpenCV twins -------------------------------------------------------

def _sizes(rng, n):
    out = [((480, 640), (240, 320)), ((96, 128), (48, 64)),
           ((97, 131), (48, 64)), ((48, 64), (96, 128))]
    for _ in range(n):
        out.append((tuple(int(v) for v in rng.integers(2, 150, 2)),
                    tuple(int(v) for v in rng.integers(1, 200, 2))))
    return out


def test_resize_uint8_linear_and_nearest_give_cv2_bits():
    rng = np.random.default_rng(0)
    for (h0, w0), (h, w) in _sizes(rng, 60):
        for c in (1, 3):
            img = rng.integers(0, 256, (h0, w0, c) if c > 1 else (h0, w0),
                               dtype=np.uint8)
            for interp in (cv2.INTER_LINEAR, cv2.INTER_NEAREST):
                np.testing.assert_array_equal(
                    cv.resize(img, (w, h), interp),
                    cv2.resize(img, (w, h), interpolation=interp))


def test_resize_nearest_any_dtype_gives_cv2_bits():
    rng = np.random.default_rng(1)
    for (h0, w0), (h, w) in _sizes(rng, 30):
        for dt in (np.int32, np.float32, np.uint8):
            img = (rng.random((h0, w0, 3)) * 1000).astype(dt)
            np.testing.assert_array_equal(
                cv.resize(img, (w, h), cv.INTER_NEAREST),
                cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


# IPP's float32 resizes against the twins, on the shapes the port resizes
# floats at: the GP noise field (gaussian_scale 0.005, upsampled 4x by
# INTER_CUBIC), largest difference measured 5.6e-9; and INTER_LINEAR of
# unit-scale images at half and at double size (a frame served at half its
# size), 4.8e-7. (By other factors IPP's INTER_LINEAR differs more: 7.7e-6
# measured at 3x up, 1.4e-4 at 0.625x down, where it filters otherwise; the
# twin follows OpenCV's own code there too.)
IPP_CASES = {
    cv2.INTER_CUBIC: (0.005, 6e-9, [((60, 80), (240, 320)),
                                    ((12, 16), (48, 64)),
                                    ((24, 32), (96, 128)),
                                    ((120, 160), (480, 640))]),
    cv2.INTER_LINEAR: (1.0, 5e-7, [((480, 640), (240, 320)),
                                   ((96, 128), (48, 64)),
                                   ((48, 64), (96, 128))])}


@pytest.mark.parametrize("interp", [cv2.INTER_LINEAR, cv2.INTER_CUBIC])
def test_resize_float32_gives_opencv_bits_and_stays_near_ipp(interp):
    """float32 INTER_LINEAR and INTER_CUBIC: OpenCV's own code (IPP off) bit
    for bit over a sweep of sizes; this build's IPP path (on by default)
    within the bound measured on the port's shapes."""
    rng = np.random.default_rng(2)
    scale, bound, ipp_cases = IPP_CASES[interp]
    try:
        cv2.ipp.setUseIPP(False)
        for (h0, w0), (h, w) in ipp_cases + _sizes(rng, 30):
            for c in (1, 3):
                img = rng.normal(0, scale, (h0, w0, c)).astype(np.float32)
                np.testing.assert_array_equal(
                    cv.resize(img, (w, h), interp),
                    cv2.resize(img, (w, h), interpolation=interp))
    finally:
        cv2.ipp.setUseIPP(True)
    worst = 0.0
    for (h0, w0), (h, w) in ipp_cases:
        for c in (1, 3):
            img = rng.normal(0, scale, (h0, w0, c)).astype(np.float32)
            diff = cv.resize(img, (w, h), interp) - cv2.resize(
                img, (w, h), interpolation=interp)
            worst = max(worst, float(np.abs(diff).max()))
    assert worst <= bound, worst


def _all_colors(width):
    c = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                   -1).astype(np.uint8)
    n = len(img) // width * width
    return img[:n].reshape(-1, width, 3)


@pytest.mark.parametrize("width", [4096, 97])
def test_bgr_to_hls_gives_cv2_bits_for_every_color(width):
    """Every uint8 colour; at width 97 each row ends in the scalar tail."""
    img = _all_colors(width)
    np.testing.assert_array_equal(cv.bgr_to_hls(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HLS))


@pytest.mark.parametrize("width", [256, 97])
def test_hls_to_bgr_gives_cv2_bits_for_every_input(width):
    h, l, s = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    hls = np.stack([h, l, s], -1).reshape(-1, 3).astype(np.uint8)
    n = len(hls) // width * width
    hls = hls[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(cv.hls_to_bgr(hls),
                                  cv2.cvtColor(hls, cv2.COLOR_HLS2BGR))


def test_channel_swaps_give_cv2_bits():
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(cv.bgr_to_rgb(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(cv.rgb_to_bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.mark.parametrize("size", [3, 5, 7, 9, 11, 15])
def test_filter2d_motion_blur_gives_cv2_bits(size):
    """The kernels ``augmentation.add_noise`` draws (15: OpenCV's DFT path)
    on the loaders' shapes, and random 3x3 kernels."""
    rng = np.random.default_rng(size)
    for horizontal in (True, False):
        k = np.zeros((size, size), np.float32)
        if horizontal:
            k[(size - 1) // 2, :] = 1.0
        else:
            k[:, (size - 1) // 2] = 1.0
        for hw in ((48, 64), (97, 131), (480, 640)):
            img = rng.integers(0, 256, hw + (3,), np.uint8)
            np.testing.assert_array_equal(cv.filter2d(img, k / size),
                                          cv2.filter2D(img, -1, k / size))
    k = rng.normal(0, 0.3, (3, 3)).astype(np.float32)
    img = rng.integers(0, 256, (40, 50, 3), np.uint8)
    np.testing.assert_array_equal(cv.filter2d(img, k),
                                  cv2.filter2D(img, -1, k))


def test_fill_ellipse_gives_cv2_bits():
    """Ellipses as the dropouts draw them (radii gamma(10, 1), centres on
    the mask, some crossing its edge) plus small, flat and large ones."""
    rng = np.random.default_rng(4)
    for _ in range(1500):
        h, w = (int(v) for v in rng.integers(5, 130, 2))
        center = (int(rng.integers(-20, w + 20)),
                  int(rng.integers(-20, h + 20)))
        scale = float(rng.choice([0.2, 1.0, 3.0, 8.0]))
        axes = tuple(int(round(v)) for v in rng.gamma(10, scale, 2))
        angle = int(rng.integers(0, 360))
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, center, axes, angle=angle, startAngle=0,
                    endAngle=360, color=1, thickness=-1)
        got = cv.fill_ellipse(np.zeros((h, w), np.uint8), center, axes,
                              angle, 1)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{(h, w)} {center} {axes} "
                                              f"{angle}")
