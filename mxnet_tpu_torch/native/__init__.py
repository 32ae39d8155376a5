"""The port's native IO library (``mxtpu_io.cc``), bound through ctypes.

Counterpart of ``mxnet_tpu/native/__init__.py``: RecordIO scan, read and
pack, the uint8 HWC -> float32 CHW normalisation, the OpenMP JPEG batch
decode (align-corners bilinear resize) with its fused crop, mirror and
jitter. Three parts take the place of the JAX package's PIL calls: the
PNG decoder (the chunk walk, the unfiltering and the conversion to RGB
in C++; the stream inflated in one call of the standard library's
``zlib``, which releases the GIL), a copy of Pillow's ``BILINEAR`` resample
(``Resample.c``), and the PNG and JPEG encoders of ``recordio.pack_img``.

The library is built with ``g++`` at first use into
``build/mxnet_tpu_torch/``, named by a hash of its source and flags and
moved into place with ``os.replace`` (processes building it at once are
safe). It links ``-ljpeg`` where ``jpeglib.h`` and the library are
found; without them it is built with the JPEG entry points compiled out,
``status()`` says so, and a JPEG payload raises :class:`MXNetError`
naming libjpeg.
``-fopenmp`` is used where the compiler has its OpenMP runtime (the JPEG
batch entries' threads; the PNG path is threaded from Python). A missing
compiler raises. Nothing falls back to Python.

Each entry point has a plain numpy version here (``*_plain``): the tests
hold the library against them bit for bit; nothing on the main path uses
them. ``plain_versions()`` routes every entry point to its plain version
for the duration of a ``with`` block (a comparison run over the same
iterator); the JPEG plain versions take the pixels from libjpeg and
resize and augment in numpy.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from collections import namedtuple
from pathlib import Path

import numpy as _np

from ..base import MXNetError

__all__ = ["status", "build", "plain_versions",
           "recordio_scan", "recordio_read", "recordio_pack",
           "normalize_batch", "resample_bilinear", "augment",
           "png_info", "png_inflate", "png_decode", "png_decode_augment",
           "png_encode", "png_filter", "jpeg_decode", "jpeg_encode",
           "decode_jpeg_batch", "decode_augment_batch", "is_png", "is_jpeg",
           "PngInfo"]

_SRC = Path(__file__).resolve().with_name("mxtpu_io.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mxnet_tpu_torch"
BASE_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
              "-ffp-contract=off")
GXX_TIMEOUT_S = 300

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_lock = threading.Lock()
_lib = None
_status = {}
_plain = False


# ------------------------------------------------------------------ build --

def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise MXNetError("no C++ compiler (g++, c++ or $CXX) on PATH: the "
                     "native IO library cannot be built on this host")


def _compiles(cxx, source, flags):
    """Whether ``source`` compiles and links with ``flags`` here."""
    try:
        proc = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull,
                               *flags], input=source, text=True,
                              capture_output=True, timeout=GXX_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def _libjpeg_found(cxx):
    """Whether ``jpeglib.h`` compiles and ``-ljpeg`` links here."""
    return _compiles(cxx, "#include <cstdio>\n#include <jpeglib.h>\n"
                     "int main() { jpeg_compress_struct c; "
                     "jpeg_std_error(nullptr); return sizeof(c) == 0; }\n",
                     ["-ljpeg"])


def _openmp_found(cxx):
    """Whether ``-fopenmp`` compiles and links here (a compiler can lack
    its OpenMP runtime; only the JPEG batch entries use it)."""
    return _compiles(cxx, "#include <omp.h>\nint main() { return "
                     "omp_get_max_threads() < 0; }\n", ["-fopenmp"])


def build(force=False):
    """Build (unless built) and return ``(path, flags, jpeg)``."""
    cxx = _compiler()
    jpeg = _libjpeg_found(cxx)
    flags = [f for f in BASE_FLAGS if f != "-fopenmp" or
             _openmp_found(cxx)] + ([] if jpeg else ["-DMXTPU_NO_JPEG"])
    libs = ["-ljpeg"] if jpeg else []
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(flags + libs).encode())
    so = BUILD_DIR / f"libmxtpu_io-{h.hexdigest()[:16]}.so"
    if force or not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        cmd = [cxx, *flags, str(_SRC), "-o", str(tmp), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0:
            raise MXNetError(f"building the native IO library failed "
                             f"({proc.returncode}): {' '.join(cmd)}\n"
                             f"{proc.stderr[-2000:]}")
        os.replace(tmp, so)
    return str(so), flags + libs, jpeg


_P = ctypes.POINTER
_U8, _U64, _I32, _F32, _LL = (_P(ctypes.c_uint8), _P(ctypes.c_uint64),
                              _P(ctypes.c_int32), _P(ctypes.c_float),
                              _P(ctypes.c_longlong))
_SIGNATURES = {
    "mxtpu_recordio_scan": (ctypes.c_longlong, [ctypes.c_char_p, _U64, _U64,
                                                ctypes.c_longlong, _LL]),
    "mxtpu_recordio_read": (ctypes.c_int, [ctypes.c_char_p, _U64, _U64,
                                           ctypes.c_longlong, _U8]),
    "mxtpu_normalize_hwc_u8_to_chw_f32": (
        None, [_U8, _F32] + [ctypes.c_longlong] * 4 + [_F32, _F32,
                                                       ctypes.c_float]),
    "mxtpu_recordio_pack": (ctypes.c_longlong, [_U8, _U64, ctypes.c_longlong,
                                                _U8]),
    "mxtpu_resample_bilinear": (None, [_U8] + [ctypes.c_int] * 4 + [_U8]),
    "mxtpu_augment": (None, [_U8] + [ctypes.c_int] * 6 + [_F32, _U8]),
    "mxtpu_png_to_rgb": (ctypes.c_int, [_U8, ctypes.c_longlong]
                         + [ctypes.c_int] * 4 + [_U8, ctypes.c_int, _U8]),
    # the per-record PNG calls take addresses (``ndarray.ctypes.data``) and
    # bytes: cheaper to convert than POINTER arguments
    "mxtpu_png_info": (ctypes.c_longlong, [ctypes.c_void_p, ctypes.c_longlong,
                                           _P(ctypes.c_int), _LL, _LL,
                                           ctypes.c_longlong, _LL]),
    "mxtpu_png_decode_augment": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_char_p] + [ctypes.c_int] * 8
        + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    "mxtpu_png_filter": (None, [_U8] + [ctypes.c_int] * 4 + [_U8]),
    "mxtpu_has_jpeg": (ctypes.c_int, []),
    "mxtpu_jpeg_size": (ctypes.c_int, [_U8, ctypes.c_uint64,
                                       _P(ctypes.c_int), _P(ctypes.c_int)]),
    "mxtpu_jpeg_decode": (ctypes.c_int, [_U8, ctypes.c_uint64, ctypes.c_int,
                                         ctypes.c_int, _U8]),
    "mxtpu_decode_jpeg_batch": (
        ctypes.c_longlong, [_U8, _U64, _U64, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, _U8, _LL, ctypes.c_int]),
    "mxtpu_decode_augment_batch": (
        ctypes.c_longlong, [_U8, _U64, _U64, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [_I32, _I32, _U8, _F32, _U8, _LL,
                                ctypes.c_int]),
    "mxtpu_jpeg_encode": (ctypes.c_int, [_U8, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, _P(_U8),
                                         _P(ctypes.c_ulong)]),
    "mxtpu_free": (None, [ctypes.c_void_p]),
}


def _load():
    """The loaded library, built first if needed (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path, flags, jpeg = build()
            lib = ctypes.CDLL(path)
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.restype, fn.argtypes = res, args
            _status.update(lib_path=path, flags=flags,
                           jpeg=bool(lib.mxtpu_has_jpeg()))
            if _status["jpeg"] != jpeg:
                raise MXNetError("native IO library: the libjpeg probe "
                                 "and the built library disagree")
            _lib = lib
    return _lib


def status():
    """``{"available", "lib_path", "flags", "jpeg", "png", "openmp",
    "error"}``: the build's state; ``jpeg`` False means JPEG payloads
    raise."""
    try:
        _load()
        return {"available": True, **_status, "png": True,
                "openmp": "-fopenmp" in _status["flags"], "error": None}
    except MXNetError as e:
        return {"available": False, "lib_path": None, "flags": None,
                "jpeg": False, "png": False, "openmp": False,
                "error": str(e)}


def _no_jpeg():
    return MXNetError(
        "JPEG payload, but the native IO library was built without "
        "libjpeg (jpeglib.h or -ljpeg not found by the compiler): JPEG "
        "records cannot be decoded or encoded on this host; pack PNG "
        "records (recordio.pack_img(..., img_fmt='.png'))")


def _jpeg_lib():
    lib = _load()
    if not _status["jpeg"]:
        raise _no_jpeg()
    return lib


@contextlib.contextmanager
def plain_versions():
    """Route every entry point to its plain numpy version inside the
    block (process-wide: the iterators' threads see it too)."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def _ptr(a, kind=_U8):
    return a.ctypes.data_as(kind)


# -------------------------------------------------------------- RecordIO --

def recordio_scan(path):
    """``(offsets, lengths)`` (uint64) of every record's payload of a
    ``.rec`` file; ValueError on bad framing or a multi-part record,
    OSError when the file cannot be opened."""
    if _plain:
        return recordio_scan_plain(path)
    lib = _load()
    cap = 1024
    where = ctypes.c_longlong(0)
    while True:
        offs = _np.zeros(cap, _np.uint64)
        lens = _np.zeros(cap, _np.uint64)
        n = lib.mxtpu_recordio_scan(os.fsencode(path), _ptr(offs, _U64),
                                    _ptr(lens, _U64), cap,
                                    ctypes.byref(where))
        if n >= 0:
            return offs[:n].copy(), lens[:n].copy()
        if n == -1:
            raise OSError(where.value, os.strerror(where.value), path)
        if n == -2:
            raise ValueError(f"{path}: bad RecordIO magic at {where.value}")
        if n == -3:
            raise ValueError(f"{path}: multi-part RecordIO record at "
                             f"{where.value} (cflag != 0) cannot be indexed")
        cap *= 2


def recordio_scan_plain(path):
    offsets, lengths = [], []
    with open(path, "rb") as f:
        while True:
            pos = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            if magic != 0xCED7230A:
                raise ValueError(f"{path}: bad RecordIO magic at {pos}")
            if lrec >> 29:
                raise ValueError(f"{path}: multi-part RecordIO record at "
                                 f"{pos} (cflag != 0) cannot be indexed")
            length = lrec & ((1 << 29) - 1)
            offsets.append(pos + 8)
            lengths.append(length)
            f.seek((length + 3) // 4 * 4, os.SEEK_CUR)
    return (_np.asarray(offsets, _np.uint64),
            _np.asarray(lengths, _np.uint64))


def recordio_read(path, offsets, lengths):
    """The payloads at ``(offsets, lengths)`` as a list of bytes."""
    if _plain:
        return recordio_read_plain(path, offsets, lengths)
    offsets = _np.ascontiguousarray(offsets, _np.uint64)
    lengths = _np.ascontiguousarray(lengths, _np.uint64)
    buf = _np.zeros(int(lengths.sum()), _np.uint8)
    rc = _load().mxtpu_recordio_read(os.fsencode(path), _ptr(offsets, _U64),
                                     _ptr(lengths, _U64), len(offsets),
                                     _ptr(buf))
    if rc != 0:
        raise OSError(f"{path}: reading {len(offsets)} records failed")
    ends = _np.cumsum(lengths.astype(_np.int64))
    return [buf[e - int(n):e].tobytes() for e, n in zip(ends, lengths)]


def recordio_read_plain(path, offsets, lengths):
    out = []
    with open(path, "rb") as f:
        for off, ln in zip(offsets, lengths):
            f.seek(int(off))
            out.append(f.read(int(ln)))
    return out


def recordio_pack(payloads):
    """RecordIO framing of a list of payloads, as one bytes object."""
    if _plain:
        return recordio_pack_plain(payloads)
    lengths = _np.asarray([len(p) for p in payloads], _np.uint64)
    src = _np.frombuffer(b"".join(payloads), _np.uint8)
    dst = _np.zeros(int(sum(8 + (int(n) + 3) // 4 * 4 for n in lengths)),
                    _np.uint8)
    n = _load().mxtpu_recordio_pack(_ptr(src), _ptr(lengths, _U64),
                                    len(payloads), _ptr(dst))
    return dst[:n].tobytes()


def recordio_pack_plain(payloads):
    out = bytearray()
    for p in payloads:
        out += struct.pack("<II", 0xCED7230A, len(p))
        out += p
        out += b"\x00" * ((len(p) + 3) // 4 * 4 - len(p))
    return bytes(out)


# --------------------------------------------------------- normalisation --

def _mean_std_inv(mean, std):
    m = None if mean is None else _np.ascontiguousarray(mean, _np.float32)
    # the reciprocal in float32, multiplied: the native arithmetic
    s = None if std is None else \
        (1.0 / _np.ascontiguousarray(std, _np.float32)).astype(_np.float32)
    return m, s


def normalize_batch(images_u8_hwc, mean=None, std=None, scale=1.0):
    """(N, H, W, C) uint8 -> (N, C, H, W) float32, ``(x * scale - mean) *
    (1 / std)`` per channel in float32."""
    if _plain:
        return normalize_batch_plain(images_u8_hwc, mean, std, scale)
    src = _np.ascontiguousarray(images_u8_hwc, _np.uint8)
    n, h, w, c = src.shape
    out = _np.empty((n, c, h, w), _np.float32)
    m, s = _mean_std_inv(mean, std)
    _load().mxtpu_normalize_hwc_u8_to_chw_f32(
        _ptr(src), _ptr(out, _F32), n, h, w, c,
        None if m is None else _ptr(m, _F32),
        None if s is None else _ptr(s, _F32), ctypes.c_float(scale))
    return out


def normalize_batch_plain(images_u8_hwc, mean=None, std=None, scale=1.0):
    m, s = _mean_std_inv(mean, std)
    out = _np.asarray(images_u8_hwc, _np.uint8).astype(_np.float32) \
        * _np.float32(scale)
    if m is not None:
        out = out - m
    if s is not None:
        out = out * s
    return _np.ascontiguousarray(out.transpose(0, 3, 1, 2))


# ---------------------------------------------- Pillow BILINEAR resample --

def resample_bilinear(img, oh, ow):
    """``Image.resize((ow, oh), Image.BILINEAR)`` of an (h, w, 3) uint8
    RGB image, bit for bit."""
    if _plain:
        return resample_bilinear_plain(img, oh, ow)
    src = _np.ascontiguousarray(img, _np.uint8)
    h, w, c = src.shape
    if c != 3 or min(h, w, oh, ow) < 1:
        raise ValueError(f"resample_bilinear takes (h, w, 3) RGB to a "
                         f"positive size, got {src.shape} -> {(oh, ow)}")
    out = _np.empty((oh, ow, 3), _np.uint8)
    _load().mxtpu_resample_bilinear(_ptr(src), h, w, oh, ow, _ptr(out))
    return out


def _pillow_coeffs(in_size, out_size):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    BILINEAR filter: ``(xmin, taps, int weights)``."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(_np.ceil(support)) * 2 + 1
    xmins = _np.zeros(out_size, _np.int64)
    kk = _np.zeros((out_size, ksize), _np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int(-0.5 + w * (1 << 22)) if w < 0 \
                else int(0.5 + w * (1 << 22))
        xmins[xx] = xmin
    return xmins, kk


def _pillow_pass(img, out_size, axis):
    """One separable pass along ``axis`` (1: columns, 0: rows)."""
    in_size = img.shape[axis]
    xmins, kk = _pillow_coeffs(in_size, out_size)
    idx = _np.minimum(xmins[:, None] + _np.arange(kk.shape[1])[None, :],
                      in_size - 1)
    src = img.astype(_np.int64)
    if axis == 1:
        taps = src[:, idx, :] * kk[None, :, :, None]
        acc = taps.sum(axis=2)
    else:
        taps = src[idx, :, :] * kk[:, :, None, None]
        acc = taps.sum(axis=1)
    acc = acc + (1 << 21)
    return _np.where(acc >= (1 << 30), 255,
                     _np.where(acc <= 0, 0, acc >> 22)).astype(_np.uint8)


def resample_bilinear_plain(img, oh, ow):
    out = _np.asarray(img, _np.uint8)
    if out.shape[1] != ow:
        out = _pillow_pass(out, ow, 1)
    if out.shape[0] != oh:
        out = _pillow_pass(out, oh, 0)
    return out.copy() if out is img else out


# ----------------------------------------------------------- augmentation --

def augment(img, y, x, oh, ow, mirror=False, jitter=None):
    """Crop (oh, ow) at (y, x) of an (h, w, 3) uint8 image, mirror it, and
    scale each channel by ``jitter`` (float32 multiply, +0.5, truncate,
    clamp 255)."""
    if _plain:
        return augment_plain(img, y, x, oh, ow, mirror, jitter)
    src = _np.ascontiguousarray(img, _np.uint8)
    _check_window(src.shape, y, x, oh, ow)
    out = _np.empty((oh, ow, 3), _np.uint8)
    jit = None if jitter is None else \
        _np.ascontiguousarray(jitter, _np.float32)
    _load().mxtpu_augment(_ptr(src), src.shape[1], int(y), int(x), oh, ow,
                          int(bool(mirror)),
                          None if jit is None else _ptr(jit, _F32),
                          _ptr(out))
    return out


def _check_window(shape, y, x, oh, ow):
    if len(shape) != 3 or shape[2] != 3 or not (
            0 <= y and 0 <= x and y + oh <= shape[0] and x + ow <= shape[1]
            and oh > 0 and ow > 0):
        raise ValueError(f"window ({oh}, {ow}) at ({y}, {x}) is outside "
                         f"the (h, w, 3) image {tuple(shape)}")


def augment_plain(img, y, x, oh, ow, mirror=False, jitter=None):
    out = _np.asarray(img, _np.uint8)[y:y + oh, x:x + ow]
    if mirror:
        out = out[:, ::-1]
    if jitter is not None:
        out = _np.minimum(out.astype(_np.float32)
                          * _np.asarray(jitter, _np.float32) + 0.5,
                          255.0).astype(_np.uint8)
    return _np.ascontiguousarray(out)


# ------------------------------------------------------------------- PNG --

PngInfo = namedtuple("PngInfo", ["width", "height", "depth", "color_type",
                                 "interlace", "palette", "idat"])
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(buf):
    return bytes(buf[:8]) == PNG_SIGNATURE


def is_jpeg(buf):
    return bytes(buf[:3]) == b"\xff\xd8\xff"


_PNG_WALK_ERRORS = {-1: "not a PNG (bad signature)",
                    -2: "truncated PNG chunk",
                    -4: "PNG without IHDR or IDAT",
                    -5: "PNG IHDR of the wrong length"}


def png_info(buf):
    """The header, palette and deflated IDAT stream of a PNG (the chunk
    walk in C; the stream is a view of ``buf`` when it is one chunk).
    ValueError for a damaged file; :class:`MXNetError` for a valid format
    that is not ported (interlaced, 16-bit samples)."""
    if _plain:
        return png_info_plain(buf)
    src = _np.frombuffer(buf, _np.uint8)
    ihdr = (ctypes.c_int * 7)()
    plte = (ctypes.c_longlong * 2)()
    cap = 8
    while True:
        idat = (ctypes.c_longlong * (2 * cap))()
        where = ctypes.c_longlong(0)
        n = _load().mxtpu_png_info(src.ctypes.data, len(src), ihdr, plte,
                                   idat, cap, ctypes.byref(where))
        if n <= cap:
            break
        cap = n
    if n == -3:
        kind = bytes(src[where.value + 4:where.value + 8])
        raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
    if n < 0:
        raise ValueError(_PNG_WALK_ERRORS.get(n, f"PNG walk error {n}"))
    mv = memoryview(src)
    if n == 1:
        data = mv[idat[0]:idat[0] + idat[1]]
    else:
        data = b"".join(mv[idat[2 * i]:idat[2 * i] + idat[2 * i + 1]]
                        for i in range(n))
    palette = bytes(mv[plte[0]:plte[0] + plte[1]]) if plte[1] else None
    return _png_checked(tuple(ihdr), palette, data)


def _png_checked(ihdr, palette, idat):
    """A PngInfo from IHDR's fields, or the error png_info raises."""
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or comp or filt or w <= 0 or h <= 0:
        raise ValueError(f"bad PNG header {ihdr}")
    if depth == 16:
        raise MXNetError("16-bit PNG samples are not ported (8-bit gray, "
                         "gray+alpha, RGB, RGBA and palette images are)")
    if interlace:
        raise MXNetError("interlaced (Adam7) PNG is not ported")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"bad PNG bit depth {depth} for color type {ctype}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    return PngInfo(w, h, depth, ctype, interlace, palette or b"", idat)


def png_info_plain(buf):
    mv = memoryview(buf)
    if bytes(mv[:8]) != PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(mv):
        length, kind = struct.unpack(">I4s", mv[pos:pos + 8])
        data = mv[pos + 8:pos + 8 + length]
        if len(data) < length or pos + 12 + length > len(mv):
            raise ValueError("truncated PNG chunk")
        if kind in (b"IHDR", b"PLTE"):
            crc = struct.unpack(">I", mv[pos + 8 + length:pos + 12 + length])
            if zlib.crc32(data, zlib.crc32(kind)) != crc[0]:
                raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            if length != 13:
                raise ValueError("PNG IHDR of the wrong length")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = bytes(data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    return _png_checked(ihdr, palette, b"".join(idat))


def png_inflate(info):
    """The inflated scanlines of ``info``'s IDAT stream (stdlib zlib,
    which releases the GIL), into a buffer of the image's size: one
    inflate call."""
    ch = _CHANNELS[info.color_type]
    size = info.height * ((info.width * ch * info.depth + 7) // 8 + 1)
    try:
        return zlib.decompress(info.idat, 15, size)
    except zlib.error as e:
        raise ValueError(f"PNG IDAT stream: {e}") from None


_PNG_ERRORS = {-1: "unsupported PNG format", -2: "bad PNG filter type",
               -3: "PNG image data shorter than the image",
               -4: "out of memory"}


def _png_check(rc):
    if rc:
        raise ValueError(_PNG_ERRORS.get(rc, f"PNG decode error {rc}"))


def png_to_rgb(raw, info):
    """Unfilter the inflated stream ``raw`` of ``info`` -> (h, w, 3) RGB,
    as PIL's ``convert("RGB")``."""
    if _plain:
        return png_to_rgb_plain(raw, info)
    src = _np.frombuffer(raw, _np.uint8)
    pal = _np.frombuffer(info.palette or b"\0", _np.uint8)
    out = _np.empty((info.height, info.width, 3), _np.uint8)
    _png_check(_load().mxtpu_png_to_rgb(
        _ptr(src), len(src), info.width, info.height, info.depth,
        info.color_type, _ptr(pal), len(info.palette) // 3, _ptr(out)))
    return out


def png_decode(buf):
    """A PNG payload -> (h, w, 3) uint8 RGB."""
    info = png_info(buf)
    return png_to_rgb(png_inflate(info), info)


def png_decode_augment(raw, info, dh, dw, oh, ow, y=0, x=0, mirror=False,
                       jitter=None, normalize=None, planes=None):
    """The inflated stream ``raw`` of ``info`` -> RGB -> Pillow's
    BILINEAR resample to (dh, dw) where the size differs -> crop (oh, ow)
    at (y, x), mirror, jitter: a (oh, ow, 3) uint8 image. With
    ``normalize = (mean, std, scale)`` it is written instead into
    ``planes`` (contiguous float32 (3, oh, ow)) as :func:`normalize_batch`
    computes it, and ``planes`` is returned."""
    if _plain:
        res = augment_plain(resample_bilinear_plain(
            png_to_rgb_plain(raw, info), dh, dw), y, x, oh, ow, mirror,
            jitter)
        if planes is None:
            return res
        planes[...] = normalize_batch_plain(res[None], *normalize)[0]
        return planes
    raw = raw if isinstance(raw, bytes) else bytes(raw)
    out = m = s = None
    scale = 1.0
    if planes is None:
        out = _np.empty((oh, ow, 3), _np.uint8)
    else:
        if planes.shape != (3, oh, ow) or planes.dtype != _np.float32 or \
                not planes.flags.c_contiguous:
            raise ValueError(f"png_decode_augment: planes must be a "
                             f"contiguous float32 {(3, oh, ow)}")
        mean, std, scale = normalize
        m, s = _mean_std_inv(mean, std)
    jit = None if jitter is None else \
        _np.ascontiguousarray(jitter, _np.float32)
    _png_check(_load().mxtpu_png_decode_augment(
        raw, len(raw), info.width, info.height, info.depth,
        info.color_type, info.palette or b"\0", len(info.palette) // 3, dh,
        dw, oh, ow, int(y), int(x), int(bool(mirror)),
        None if jit is None else jit.ctypes.data,
        None if out is None else out.ctypes.data,
        None if m is None else m.ctypes.data,
        None if s is None else s.ctypes.data, scale,
        None if planes is None else planes.ctypes.data))
    return out if planes is None else planes


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_plain(raw, h, stride, bpp):
    data = _np.frombuffer(raw, _np.uint8)
    if len(data) < h * (stride + 1):
        raise ValueError(_PNG_ERRORS[-3])
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    rows = _np.zeros((h, stride), _np.uint8)
    prev = _np.zeros(stride, _np.int64)
    for y in range(h):
        ft, line = int(data[y, 0]), data[y, 1:].astype(_np.int64)
        if ft == 0:
            cur = line
        elif ft == 1 and stride % bpp == 0:
            cur = _np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ft == 2:
            cur = (line + prev) % 256
        elif ft in (1, 3, 4):
            vals, up = line.tolist(), prev.tolist()
            for i in range(stride):
                a = vals[i - bpp] if i >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                vals[i] = (vals[i] + pred) % 256
            cur = _np.asarray(vals, _np.int64)
        else:
            raise ValueError(_PNG_ERRORS[-2])
        rows[y] = cur
        prev = cur
    return rows


def png_to_rgb_plain(raw, info):
    w, h, depth, ctype = info.width, info.height, info.depth, \
        info.color_type
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter_plain(raw, h, stride, (ch * depth + 7) // 8)
    if depth < 8:
        bits = _np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << _np.arange(depth - 1, -1, -1)
        vals = (bits * weights).sum(axis=2)[:, :w]
        if ctype == 0:
            g = (vals * {1: 255, 2: 85, 4: 17}[depth]).astype(_np.uint8)
            return _np.repeat(g[..., None], 3, axis=2)
        samples = vals[..., None]
    else:
        samples = rows.reshape(h, w, ch)
    if ctype == 3:
        pal = _np.zeros((256, 3), _np.uint8)
        p = _np.frombuffer(info.palette, _np.uint8)[:768]
        pal[:len(p) // 3] = p[:len(p) // 3 * 3].reshape(-1, 3)
        return pal[samples[..., 0]]
    if ctype in (0, 4):
        return _np.repeat(samples[..., :1], 3, axis=2).astype(_np.uint8)
    return _np.ascontiguousarray(samples[..., :3], _np.uint8)


def png_filter(img, filter_type=1):
    """The encoder's scanlines of an (h, w, c) uint8 image: per row a
    filter byte (0 None, 1 Sub) and the filtered bytes."""
    if _plain:
        return png_filter_plain(img, filter_type)
    src = _np.ascontiguousarray(img, _np.uint8)
    h, w, c = src.shape
    out = _np.empty(h * (w * c + 1), _np.uint8)
    _load().mxtpu_png_filter(_ptr(src), h, w, c, int(filter_type), _ptr(out))
    return out.tobytes()


def png_filter_plain(img, filter_type=1):
    src = _np.asarray(img, _np.uint8)
    h, w, c = src.shape
    rows = src.reshape(h, w * c)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, c:] = src.reshape(h, w * c)[:, c:] - src.reshape(
            h, w * c)[:, :-c]
    elif filter_type != 0:
        raise ValueError("png_filter writes filter 0 (None) or 1 (Sub)")
    out = _np.empty((h, w * c + 1), _np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = rows
    return out.tobytes()


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(data, zlib.crc32(kind)))


def png_encode(img, filter_type=1, level=6):
    """An 8-bit PNG of an (h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA
    uint8 image: each scanline filtered with ``filter_type`` (0 None, 1
    Sub), deflated by ``zlib`` at ``level`` with the ``Z_FILTERED``
    strategy for filtered rows (libpng's default; ``Z_DEFAULT_STRATEGY``
    for unfiltered ones)."""
    arr = _np.asarray(img, _np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"png_encode takes 1-4 channels, got {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 8,
                         zlib.Z_FILTERED if filter_type else
                         zlib.Z_DEFAULT_STRATEGY)
    data = z.compress(png_filter(arr, filter_type)) + z.flush()
    return PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data) + \
        _chunk(b"IEND", b"")


# ------------------------------------------------------------------ JPEG --

def _jpeg_size(lib, buf):
    h, w = ctypes.c_int(), ctypes.c_int()
    src = _np.frombuffer(buf, _np.uint8)
    if lib.mxtpu_jpeg_size(_ptr(src), len(src), ctypes.byref(h),
                           ctypes.byref(w)):
        raise ValueError("not a decodable JPEG")
    return h.value, w.value


def jpeg_decode(buf):
    """A JPEG payload -> (h, w, 3) uint8 RGB at its own size (libjpeg)."""
    lib = _jpeg_lib()
    h, w = _jpeg_size(lib, buf)
    src = _np.frombuffer(buf, _np.uint8)
    out = _np.empty((h, w, 3), _np.uint8)
    if lib.mxtpu_jpeg_decode(_ptr(src), len(src), h, w, _ptr(out)):
        raise ValueError("JPEG decode failed")
    return out


def jpeg_encode(img, quality=95):
    """A baseline JPEG of an (h, w, 3) uint8 RGB image (libjpeg)."""
    lib = _jpeg_lib()
    src = _np.ascontiguousarray(img, _np.uint8)
    h, w, c = src.shape
    if c != 3:
        raise ValueError("jpeg_encode takes (h, w, 3) RGB")
    out, n = _P(ctypes.c_uint8)(), ctypes.c_ulong()
    if lib.mxtpu_jpeg_encode(_ptr(src), h, w, int(quality),
                             ctypes.byref(out), ctypes.byref(n)):
        lib.mxtpu_free(out)
        raise ValueError("JPEG encode failed")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mxtpu_free(out)


def _blob_offsets(bufs):
    lengths = _np.asarray([len(b) for b in bufs], _np.uint64)
    offsets = _np.zeros(len(bufs), _np.uint64)
    if len(bufs) > 1:
        offsets[1:] = _np.cumsum(lengths[:-1])
    return _np.frombuffer(b"".join(bufs), _np.uint8), offsets, lengths


def decode_jpeg_batch(bufs, out_h, out_w, n_threads=0):
    """JPEG payloads -> (N, out_h, out_w, 3) uint8, each resized by the
    align-corners bilinear (float32, +0.5), OpenMP over images. Returns
    ``(batch, failed indices)``; a failed slot is zero-filled."""
    if _plain:
        return decode_jpeg_batch_plain(bufs, out_h, out_w)
    lib = _jpeg_lib()
    n = len(bufs)
    blob, offsets, lengths = _blob_offsets(bufs)
    out = _np.empty((n, out_h, out_w, 3), _np.uint8)
    failed = _np.full(n, -1, _np.int64)
    lib.mxtpu_decode_jpeg_batch(_ptr(blob), _ptr(offsets, _U64),
                                _ptr(lengths, _U64), n, out_h, out_w,
                                _ptr(out), _ptr(failed, _LL), int(n_threads))
    return out, sorted(int(i) for i in failed if i >= 0)


def decode_augment_batch(bufs, dh, dw, oh, ow, crop_y=None, crop_x=None,
                         mirror=None, jitter=None, n_threads=0):
    """JPEG payloads decoded to (dh, dw), then cropped to (oh, ow) at
    (crop_y[i], crop_x[i]), mirrored where mirror[i] and scaled by
    jitter[i], OpenMP over images. Returns as :func:`decode_jpeg_batch`."""
    if _plain:
        return decode_augment_batch_plain(bufs, dh, dw, oh, ow, crop_y,
                                          crop_x, mirror, jitter)
    lib = _jpeg_lib()
    n = len(bufs)
    for name, a, hi in (("crop_y", crop_y, dh - oh), ("crop_x", crop_x,
                                                      dw - ow)):
        if hi < 0 or (a is not None and (len(a) != n or min(a, default=0) < 0
                                         or max(a, default=0) > hi)):
            raise ValueError(f"decode_augment_batch: {name} must be {n} "
                             f"offsets in [0, {hi}]")
    blob, offsets, lengths = _blob_offsets(bufs)
    out = _np.empty((n, oh, ow, 3), _np.uint8)
    failed = _np.full(n, -1, _np.int64)

    def opt(a, dtype, kind):
        if a is None:
            return None, None
        a = _np.ascontiguousarray(a, dtype)
        return a, _ptr(a, kind)

    cy, cyp = opt(crop_y, _np.int32, _I32)
    cx, cxp = opt(crop_x, _np.int32, _I32)
    mi, mip = opt(mirror, _np.uint8, _U8)
    ji, jip = opt(jitter, _np.float32, _F32)
    lib.mxtpu_decode_augment_batch(_ptr(blob), _ptr(offsets, _U64),
                                   _ptr(lengths, _U64), n, dh, dw, oh, ow,
                                   cyp, cxp, mip, jip, _ptr(out),
                                   _ptr(failed, _LL), int(n_threads))
    return out, sorted(int(i) for i in failed if i >= 0)


def resize_align_corners_plain(pixels, oh, ow):
    """The JPEG path's resize in numpy float32: align corners, +0.5,
    truncate (``resize_align_corners`` of mxtpu_io.cc)."""
    h, w = pixels.shape[:2]
    f32 = _np.float32
    sy = f32(h - 1) / f32(oh - 1) if oh > 1 else f32(0)
    sx = f32(w - 1) / f32(ow - 1) if ow > 1 else f32(0)
    fy = _np.arange(oh).astype(f32) * sy
    fx = _np.arange(ow).astype(f32) * sx
    y0, x0 = fy.astype(_np.int64), fx.astype(_np.int64)
    y1, x1 = _np.minimum(y0 + 1, h - 1), _np.minimum(x0 + 1, w - 1)
    wy = (fy - y0.astype(f32))[:, None, None]
    wx = (fx - x0.astype(f32))[None, :, None]
    p = pixels.astype(f32)
    one = f32(1)
    v = (p[y0][:, x0] * (one - wy) * (one - wx)
         + p[y0][:, x1] * (one - wy) * wx
         + p[y1][:, x0] * wy * (one - wx)
         + p[y1][:, x1] * wy * wx)
    return (v + f32(0.5)).astype(_np.uint8)


def _jpeg_pixels(buf):
    try:
        return jpeg_decode(buf)
    except ValueError:
        return None


def decode_jpeg_batch_plain(bufs, out_h, out_w):
    out = _np.zeros((len(bufs), out_h, out_w, 3), _np.uint8)
    failed = []
    for i, b in enumerate(bufs):
        px = _jpeg_pixels(b)
        if px is None:
            failed.append(i)
        else:
            out[i] = resize_align_corners_plain(px, out_h, out_w)
    return out, failed


def decode_augment_batch_plain(bufs, dh, dw, oh, ow, crop_y=None,
                               crop_x=None, mirror=None, jitter=None):
    out = _np.zeros((len(bufs), oh, ow, 3), _np.uint8)
    failed = []
    for i, b in enumerate(bufs):
        px = _jpeg_pixels(b)
        if px is None:
            failed.append(i)
            continue
        out[i] = augment_plain(
            resize_align_corners_plain(px, dh, dw),
            0 if crop_y is None else int(crop_y[i]),
            0 if crop_x is None else int(crop_x[i]), oh, ow,
            False if mirror is None else bool(mirror[i]),
            None if jitter is None else jitter[i])
    return out, failed
