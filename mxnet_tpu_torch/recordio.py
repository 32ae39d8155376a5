"""RecordIO: MXNet's packed-record file format.

Counterpart of ``mxnet_tpu/recordio.py`` (:34-247), binary-compatible
with it and with MXNet 1.x, so ``.rec``/``.idx`` sets written by either
package (or by ``im2rec``) read here and the other way round:

  record   := magic(4B) | lrecord(4B) | data | pad to 4B
  magic    = 0xced7230a
  lrecord  = cflag(3 bits) << 29 | length(29 bits)   (cflag 0: whole)
  IRHeader := flag(u32) label(f32, or flag x f32 after it) id(u64) id2(u64)

``pack_img`` encodes with the port's own encoders (``native``): PNG
always, JPEG where the native library was built with libjpeg. Images go
in and come out in BGR order, as MXNet's ``cv2`` calls have them.
"""
from __future__ import annotations

import numbers
import os
import struct
import threading
from collections import namedtuple

import numpy as np

from . import native

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LREC_MASK = (1 << 29) - 1

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential reader (``flag="r"``) or writer (``"w"``) of records."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError(f"Invalid flag {self.flag}")
        self.pid = os.getpid()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["is_open"] = self.record is not None
        d["record"] = None
        if "fidx" in d:
            d["fidx"] = None
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        is_open = d.pop("is_open", False)
        self.__dict__.update(d)
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        """A forked process reopens its own handle (reads) or refuses."""
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in multiple "
                                   "processes")

    def close(self):
        if self.record is not None and not self.record.closed:
            self.record.close()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append one record."""
        if not self.writable:
            raise ValueError(f"{self.uri} is open for reading")
        self._check_pid(allow_reset=False)
        length = len(buf)
        if length > _LREC_MASK:
            raise ValueError(f"record of {length} bytes exceeds the "
                             f"format's {_LREC_MASK}")
        self.record.write(struct.pack("<II", _MAGIC, length))
        self.record.write(buf)
        pad = (-length) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        """The next record, or None at the end of the file."""
        if self.writable:
            raise ValueError(f"{self.uri} is open for writing")
        self._check_pid(allow_reset=True)
        header = self.record.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise ValueError(f"corrupt record file {self.uri}: bad magic "
                             f"at {self.record.tell() - 8}")
        length = lrec & _LREC_MASK
        buf = self.record.read(length)
        pad = (-length) % 4
        if pad:
            self.record.read(pad)
        return buf

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Records by key through an ``.idx`` file of ``key\\toffset`` lines.
    A missing ``.idx`` is rebuilt for reading by scanning the framing
    (keys 0, 1, ...)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        # seek + read as one step: the DataLoader's threads and the
        # iterators' pools share this handle
        self._lock = threading.Lock()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "r":
            offsets, _ = native.recordio_scan(self.uri)
            for i, off in enumerate(offsets):
                key = self.key_type(i)
                self.idx[key] = int(off) - 8   # the record's header
                self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def seek(self, idx):
        if self.writable:
            raise ValueError(f"{self.uri} is open for writing")
        self._check_pid(allow_reset=True)
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """An IRHeader and a payload as one record body."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        packed = struct.pack(_IR_FORMAT, header.flag, header.label,
                             header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        packed = struct.pack(_IR_FORMAT, label.size, 0, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """A record body as ``(IRHeader, payload)``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _host_image(img):
    arr = img.asnumpy() if hasattr(img, "asnumpy") else np.asarray(img)
    return arr.astype(np.uint8)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC (or HW) uint8 image in BGR order and pack it. PNG
    for ``img_fmt=".png"``; JPEG otherwise, which needs the native library
    built with libjpeg."""
    arr = _host_image(img)
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]                 # BGR -> RGB
    if img_fmt.lower() in (".jpg", ".jpeg"):
        if arr.ndim == 2 or arr.shape[2] == 1:
            arr = np.repeat(arr.reshape(arr.shape[0], arr.shape[1], 1), 3,
                            axis=2)
        return pack(header, native.jpeg_encode(arr, quality))
    return pack(header, native.png_encode(arr))


def unpack_img(s, iscolor=1):
    """Unpack a record and decode its image, in BGR order (``iscolor=0``:
    one gray channel)."""
    from . import image

    header, img_bytes = unpack(s)
    return header, image.imdecode(img_bytes, flag=iscolor, to_rgb=False)
