"""The port's native IO library (``mxnet_tpu_torch/native``) on the CPU.

Each C++ entry point is held bit for bit against its plain numpy version
(``native.*_plain``), and against what it replaces in the JAX package:
the PNG decode and Pillow's ``BILINEAR`` resample against PIL (12.1
here), the JPEG batch decode, the fused augmenter and the normalisation
against the JAX package's native library (both link the system libjpeg;
PIL bundles another, so JPEG is not held against PIL), the RecordIO scan
and framing against the JAX functions. A build without libjpeg is made
(the probe monkeypatched) to show that a JPEG payload then raises
``MXNetError`` naming libjpeg, and the build is shown to be safe to run
from several threads at once.
"""
import io
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu.native as jnative
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import native
from mxnet_tpu_torch.base import MXNetError


def _rgb(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _smooth(seed, h, w):
    """A smooth random field with noise (compresses like a photograph)."""
    rs = np.random.RandomState(seed)
    lo = rs.uniform(0, 255, (4, 5, 3))
    ay = np.maximum(0, 1 - np.abs(np.linspace(0, 3, h)[:, None]
                                  - np.arange(4)[None]))
    ax = np.maximum(0, 1 - np.abs(np.linspace(0, 4, w)[:, None]
                                  - np.arange(5)[None]))
    f = np.stack([ay @ lo[:, :, c] @ ax.T for c in range(3)], -1)
    return np.clip(f + rs.normal(0, 4, f.shape), 0, 255).astype(np.uint8)


def _pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _jpeg(seed, h, w, quality=90):
    return _pil_bytes(Image.fromarray(_smooth(seed, h, w)), "JPEG",
                      quality=quality)


def test_status_reports_the_build():
    st = native.status()
    assert st["available"] and st["png"] and st["error"] is None
    assert st["jpeg"] is True          # this host has jpeglib.h
    assert "-ffp-contract=off" in st["flags"] and "-ljpeg" in st["flags"]
    assert not any("march" in f for f in st["flags"])


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (5, 7, 3, 4), (23, 31, 9,
                                                                  40),
                                   (40, 30, 40, 30), (64, 48, 17, 13),
                                   (256, 341, 252, 252), (341, 256, 252,
                                                          252)])
def test_resample_matches_pillow_and_the_plain_version(shape):
    h, w, oh, ow = shape
    img = _rgb(h * 1000 + w, h, w)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    assert np.array_equal(native.resample_bilinear(img, oh, ow), want)
    assert np.array_equal(native.resample_bilinear_plain(img, oh, ow), want)


def test_resample_many_random_sizes_match_pillow():
    rs = np.random.RandomState(5)
    for _ in range(60):
        h, w, oh, ow = rs.randint(1, 48, 4)
        img = _rgb(int(rs.randint(1 << 30)), h, w)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        assert np.array_equal(native.resample_bilinear(img, oh, ow), want)


def _pil_png(mode, seed, colors=None):
    img = Image.fromarray(_rgb(seed, 23, 31))
    img = img.quantize(colors=colors) if mode == "P" else img.convert(mode)
    return _pil_bytes(img, "PNG")


@pytest.mark.parametrize("mode,colors,depth,ctype", [
    ("RGB", None, 8, 2), ("RGBA", None, 8, 6), ("L", None, 8, 0),
    ("LA", None, 8, 4), ("P", 256, 8, 3), ("P", 16, 4, 3), ("P", 4, 2, 3),
    ("P", 2, 1, 3), ("1", None, 1, 0)])
def test_png_decode_matches_pil_convert_rgb(mode, colors, depth, ctype):
    buf = _pil_png(mode, 7, colors)
    info = native.png_info(buf)
    assert (info.depth, info.color_type) == (depth, ctype)
    want = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
    raw = zlib.decompress(info.idat)
    assert np.array_equal(native.png_to_rgb(raw, info), want)
    assert np.array_equal(native.png_to_rgb_plain(raw, info), want)
    assert np.array_equal(native.png_decode(buf), want)


@pytest.mark.parametrize("size", [(9, 13), (30, 40), (256, 341)])
@pytest.mark.parametrize("filter_type", [0, 1])
def test_png_encoder_roundtrips_through_pil(size, filter_type):
    img = _smooth(3, *size)
    buf = native.png_encode(img, filter_type)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(buf))), img)
    assert native.png_filter(img, filter_type) == \
        native.png_filter_plain(img, filter_type)
    gray = img[..., 0]
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(
        native.png_encode(gray)))), gray)


def test_png_every_filter_type_unfilters_like_pil():
    """PIL's encoder picks a filter per row (all five types appear on a
    noisy image); the decode is PIL's to the bit."""
    img = _smooth(11, 64, 80)
    buf = _pil_bytes(Image.fromarray(img), "PNG")
    info = native.png_info(buf)
    raw = zlib.decompress(info.idat)
    stride = 80 * 3 + 1
    assert len({raw[i * stride] for i in range(64)}) >= 3
    assert np.array_equal(native.png_decode(buf), img)
    assert np.array_equal(native.png_to_rgb_plain(raw, info), img)


@pytest.mark.parametrize("jitter", [None, (0.7, 1.0, 1.3)])
@pytest.mark.parametrize("mirror", [False, True])
def test_png_decode_augment_is_resample_then_augment(jitter, mirror):
    img = _smooth(5, 37, 53)
    buf = native.png_encode(img)
    info = native.png_info(buf)
    raw = zlib.decompress(info.idat)
    jit = None if jitter is None else np.asarray(jitter, np.float32)
    for dh, dw, oh, ow, y, x in ((37, 53, 37, 53, 0, 0),
                                 (40, 45, 32, 40, 5, 3),
                                 (30, 30, 24, 24, 6, 0)):
        pil = np.asarray(Image.fromarray(img).resize((dw, dh),
                                                     Image.BILINEAR))
        want = native.augment_plain(pil, y, x, oh, ow, mirror, jit)
        got = native.png_decode_augment(raw, info, dh, dw, oh, ow, y, x,
                                        mirror, jit)
        assert np.array_equal(got, want)
        with native.plain_versions():
            assert np.array_equal(native.png_decode_augment(
                raw, info, dh, dw, oh, ow, y, x, mirror, jit), want)
    with pytest.raises(ValueError):
        native.png_decode_augment(raw, info, 37, 53, 32, 40, 10, 20)
    # normalised as it is written: normalize_batch's float32 arithmetic
    norm = (np.asarray([120.0, 110.0, 100.0], np.float32),
            np.asarray([58.4, 57.1, 57.4], np.float32), 0.5)
    want = native.normalize_batch_plain(native.augment_plain(
        np.asarray(Image.fromarray(img).resize((45, 40), Image.BILINEAR)),
        5, 3, 32, 40, mirror, jit)[None], *norm)[0]
    for plain in (False, True):
        planes = np.empty((3, 32, 40), np.float32)
        if plain:
            with native.plain_versions():
                native.png_decode_augment(raw, info, 40, 45, 32, 40, 5, 3,
                                          mirror, jit, normalize=norm,
                                          planes=planes)
        else:
            native.png_decode_augment(raw, info, 40, 45, 32, 40, 5, 3,
                                      mirror, jit, normalize=norm,
                                      planes=planes)
        assert np.array_equal(planes, want)


def test_png_damage_is_a_value_error_and_unported_variants_raise():
    buf = native.png_encode(_rgb(1, 8, 8))
    with pytest.raises(ValueError):
        native.png_info(b"not a png at all")
    with pytest.raises(ValueError):
        native.png_decode(buf[:40])
    bad_filter = bytearray(zlib.decompress(native.png_info(buf).idat))
    bad_filter[0] = 9
    with pytest.raises(ValueError, match="filter"):
        native.png_to_rgb(bytes(bad_filter), native.png_info(buf))
    with pytest.raises(ValueError, match="filter"):
        native.png_to_rgb_plain(bytes(bad_filter), native.png_info(buf))
    deep = _pil_bytes(Image.fromarray(
        (np.arange(64).reshape(8, 8) * 1000).astype(np.uint16)), "PNG")
    with pytest.raises(MXNetError, match="16-bit PNG .* not ported"):
        native.png_info(deep)
    laced = _pil_bytes(Image.fromarray(_rgb(2, 16, 16)), "PNG")
    # the same file with the interlace byte of IHDR set (CRC recomputed)
    ihdr = bytearray(laced[16:29])
    ihdr[12] = 1
    laced = laced[:16] + bytes(ihdr) + zlib.crc32(
        bytes(ihdr), zlib.crc32(b"IHDR")).to_bytes(4, "big") + laced[33:]
    with pytest.raises(MXNetError, match="interlaced .* not ported"):
        native.png_info(laced)


def _damaged_pngs():
    """PNG payloads, valid and damaged, for the chunk walk."""
    good = native.png_encode(_rgb(4, 9, 11))
    ihdr_crc = bytearray(good)
    ihdr_crc[29] ^= 1
    pal = _pil_png("P", 3, 16)
    plte = pal.index(b"PLTE")
    plte_crc = bytearray(pal)
    plte_crc[plte + 4] ^= 1
    no_idat = good[:33] + good[-12:]
    short_ihdr = good[:8] + (12).to_bytes(4, "big") + b"IHDR" + good[16:28] \
        + zlib.crc32(good[16:28], zlib.crc32(b"IHDR")).to_bytes(4, "big") \
        + good[33:]
    # PIL cuts the stream into several IDAT chunks for a large image
    many = _pil_bytes(Image.fromarray(_rgb(5, 300, 300)), "PNG")
    return {"good": good, "palette": pal, "many_idat": many,
            "signature": b"\x89PNX" + good[4:], "truncated": good[:45],
            "ihdr_crc": bytes(ihdr_crc), "plte_crc": bytes(plte_crc),
            "no_idat": no_idat, "short_ihdr": short_ihdr,
            "nothing": good[:8]}


@pytest.mark.parametrize("case", ["good", "palette", "many_idat",
                                  "signature", "truncated", "ihdr_crc",
                                  "plte_crc", "no_idat", "short_ihdr",
                                  "nothing"])
def test_png_chunk_walk_matches_its_plain_version(case):
    """The C chunk walk gives the plain walk's PngInfo, or its error."""
    buf = _damaged_pngs()[case]
    try:
        want = native.png_info_plain(buf)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            native.png_info(buf)
        assert str(got.value) == str(e)
        return
    got = native.png_info(buf)
    assert got._replace(idat=bytes(got.idat)) == want
    assert native.png_inflate(got) == zlib.decompress(want.idat)
    if case == "many_idat":
        assert buf.count(b"IDAT") > 1
        assert np.array_equal(native.png_decode(buf), np.asarray(
            Image.open(io.BytesIO(buf)).convert("RGB")))


def test_png_inflate_reports_a_damaged_stream():
    info = native.png_info(native.png_encode(_rgb(6, 8, 8)))
    with pytest.raises(ValueError, match="IDAT stream"):
        native.png_inflate(info._replace(idat=bytes(info.idat)[:-9]))


@pytest.mark.parametrize("jitter", [False, True])
def test_augment_matches_the_jax_native_augmenter(jitter):
    """The fused augmenter through the JPEG batch entry of both libraries
    (decode to (dh, dw), crop, mirror, jitter) and the plain version."""
    bufs = [_jpeg(s, 30 + s, 40 - s) for s in range(6)] + [b"junk"]
    rs = np.random.RandomState(0)
    n = len(bufs)
    ys = rs.randint(0, 9, n).astype(np.int32)
    xs = rs.randint(0, 9, n).astype(np.int32)
    mir = (rs.rand(n) < 0.5).astype(np.uint8)
    jit = rs.uniform(0.6, 1.4, (n, 3)).astype(np.float32) if jitter \
        else None
    want, wbad = jnative.decode_augment_batch(bufs, 32, 40, 24, 32, ys, xs,
                                              mir, jit, n_threads=2)
    got, bad = native.decode_augment_batch(bufs, 32, 40, 24, 32, ys, xs,
                                           mir, jit, n_threads=2)
    plain, pbad = native.decode_augment_batch_plain(bufs, 32, 40, 24, 32,
                                                    ys, xs, mir, jit)
    assert sorted(wbad) == bad == pbad == [n - 1]
    assert np.array_equal(got, want) and np.array_equal(plain, want)
    img = _rgb(4, 20, 30)
    for y, x, m in ((0, 0, False), (3, 5, True)):
        j = None if jit is None else jit[0]
        assert np.array_equal(native.augment(img, y, x, 12, 20, m, j),
                              native.augment_plain(img, y, x, 12, 20, m, j))


def test_jpeg_batch_decode_matches_the_jax_native_decode():
    bufs = [_jpeg(s, 20 + 3 * s, 50 - 2 * s) for s in range(5)]
    for oh, ow in ((20, 50), (24, 32), (61, 7)):
        want, _ = jnative.decode_jpeg_batch(bufs, oh, ow, n_threads=3)
        got, bad = native.decode_jpeg_batch(bufs, oh, ow, n_threads=3)
        plain, _ = native.decode_jpeg_batch_plain(bufs, oh, ow)
        assert bad == [] and np.array_equal(got, want)
        assert np.array_equal(plain, want)
    # at its own size the decode is the raw pixels
    raw, _ = jnative.decode_jpeg_batch(bufs[:1], 20, 50)
    assert np.array_equal(native.jpeg_decode(bufs[0]), raw[0])


def test_jpeg_encoder_decodes_close_to_its_input():
    img = _smooth(9, 48, 64)
    buf = native.jpeg_encode(img, 95)
    assert native.is_jpeg(buf)
    got = native.jpeg_decode(buf).astype(int)
    pil = np.asarray(Image.open(io.BytesIO(_pil_bytes(
        Image.fromarray(img), "JPEG", quality=95)))).astype(int)
    # as close to the input as PIL's encoder at the same quality
    assert np.abs(got - img).mean() <= 1.25 * np.abs(pil - img).mean()
    assert np.array_equal(native.jpeg_decode(buf), np.asarray(
        jnative.decode_jpeg_batch([buf], 48, 64)[0][0]))


@pytest.mark.parametrize("std", [None, (58.395, 57.12, 57.375)])
def test_normalize_matches_the_jax_native_arithmetic(std):
    """The float32 reciprocal multiplied, as the JAX library computes
    (its Python fallback divides)."""
    batch = np.random.RandomState(0).randint(0, 256, (3, 7, 9, 3)).astype(
        np.uint8)
    mean = np.asarray([123.68, 116.28, 103.53], np.float32)
    stdv = None if std is None else np.asarray(std, np.float32)
    want = jnative.normalize_batch(batch, mean, stdv, scale=0.75)
    got = native.normalize_batch(batch, mean, stdv, scale=0.75)
    assert got.dtype == np.float32 and got.shape == (3, 3, 7, 9)
    assert np.array_equal(got, want)
    assert np.array_equal(native.normalize_batch_plain(batch, mean, stdv,
                                                       0.75), want)
    gray = batch[..., :1]
    assert np.array_equal(native.normalize_batch(gray, mean[:1]),
                          native.normalize_batch_plain(gray, mean[:1]))


def test_recordio_scan_read_pack_against_the_jax_functions(tmp_path):
    payloads = [bytes([i]) * (i * 7 % 13) for i in range(20)]
    framed = native.recordio_pack(payloads)
    assert framed == native.recordio_pack_plain(payloads) == \
        jnative.recordio_pack(payloads)
    path = str(tmp_path / "x.rec")
    with open(path, "wb") as f:
        f.write(framed)
    offs, lens = native.recordio_scan(path)
    woffs, wlens = jnative.recordio_scan(path)
    assert np.array_equal(offs, woffs) and np.array_equal(lens, wlens)
    poffs, plens = native.recordio_scan_plain(path)
    assert np.array_equal(offs, poffs) and np.array_equal(lens, plens)
    assert native.recordio_read(path, offs, lens) == payloads == \
        native.recordio_read_plain(path, offs, lens)
    with open(path, "ab") as f:
        f.write(b"\x00" * 8)
    with pytest.raises(ValueError, match=f"bad RecordIO magic at "
                                         f"{len(framed)}$"):
        native.recordio_scan(path)


@pytest.mark.parametrize("case", ["missing", "magic", "multi_part",
                                  "many"])
def test_recordio_scan_errors_match_the_plain_walk(tmp_path, case):
    """Each failure of the C scan raises what the plain walk raises, and
    a file of more records than the first capacity scans whole."""
    path = str(tmp_path / "x.rec")
    payloads = [bytes([i % 251]) * (i % 5) for i in range(
        3000 if case == "many" else 4)]
    framed = bytearray(native.recordio_pack(payloads))
    if case == "magic":
        framed[8:12] = b"\0\0\0\0"
    elif case == "multi_part":
        framed[4:8] = ((1 << 29) | 0).to_bytes(4, "little")
    if case != "missing":
        with open(path, "wb") as f:
            f.write(framed)
    try:
        want = native.recordio_scan_plain(path)
    except (OSError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            native.recordio_scan(path)
        assert str(got.value) == str(e) or case == "missing"
        return
    got = native.recordio_scan(path)
    assert len(got[0]) == len(payloads)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_a_build_without_libjpeg_raises_on_jpeg(monkeypatch, tmp_path):
    """The library built as on a host without jpeglib.h: JPEG entry points
    compiled out, status() says so, JPEG payloads raise naming libjpeg;
    PNG still decodes."""
    monkeypatch.setattr(native, "_libjpeg_found", lambda cxx: False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", {})
    st = native.status()
    assert st["available"] and st["jpeg"] is False
    assert "-DMXTPU_NO_JPEG" in st["flags"]
    jpg = _jpeg(1, 16, 16)
    for call in (lambda: native.decode_jpeg_batch([jpg], 8, 8),
                 lambda: native.decode_augment_batch([jpg], 8, 8, 8, 8),
                 lambda: native.jpeg_decode(jpg),
                 lambda: native.jpeg_encode(_rgb(0, 4, 4)),
                 lambda: mx.image.imdecode(jpg)):
        with pytest.raises(MXNetError, match="libjpeg"):
            call()
    png = native.png_encode(_rgb(0, 5, 6))
    assert np.array_equal(native.png_decode(png), _rgb(0, 5, 6))


def test_a_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(MXNetError, match="no C\\+\\+ compiler"):
        native.build(force=True)


def test_concurrent_builds_replace_atomically(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build(force=True)[0])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].rsplit(
        "/", 1)[1]]


def test_a_build_without_openmp_decodes_the_same(monkeypatch):
    """A compiler without its OpenMP runtime (the card machine's): the
    library is built without -fopenmp and the JPEG batch entries run on
    one thread, with the same bytes."""
    bufs = [_jpeg(s, 24, 30) for s in range(3)]
    want, _ = native.decode_jpeg_batch(bufs, 20, 20, n_threads=2)
    monkeypatch.setattr(native, "_openmp_found", lambda cxx: False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", {})
    st = native.status()
    assert st["available"] and st["openmp"] is False
    assert "-fopenmp" not in st["flags"]
    got, bad = native.decode_jpeg_batch(bufs, 20, 20, n_threads=2)
    assert bad == [] and np.array_equal(got, want)


def test_windows_and_sizes_are_checked_before_the_library_sees_them():
    img = _rgb(0, 10, 12)
    with pytest.raises(ValueError, match="outside"):
        native.augment(img, 5, 0, 8, 8)
    with pytest.raises(ValueError, match="positive size"):
        native.resample_bilinear(img, 0, 4)
    with pytest.raises(ValueError, match="crop_x must be"):
        native.decode_augment_batch([_jpeg(0, 10, 12)], 10, 12, 8, 8,
                                    [0], [5])
