"""RecordIO on the CPU: the port's ``recordio`` against the JAX
package's. Records, indexes, IRHeaders and packed images written by
either package read in the other, bit for bit; an ``.idx`` that is
missing is rebuilt; the token shards of ``TokenRecordIter`` are the JAX
package's."""
import io

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as rec

CPU = mx.cpu()


def _img(seed, h=12, w=17):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("writer,reader", [(rec, jrec), (jrec, rec)])
def test_sequential_records_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / "s.rec")
    payloads = [b"", b"a", b"abcd", b"x" * 37, bytes(range(256))]
    w = writer.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = reader.MXRecordIO(path, "r")
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    assert got == payloads
    r.reset()
    assert r.read() == b""


@pytest.mark.parametrize("writer,reader", [(rec, jrec), (jrec, rec)])
def test_indexed_records_cross_read(tmp_path, writer, reader):
    idx, path = str(tmp_path / "i.idx"), str(tmp_path / "i.rec")
    w = writer.MXIndexedRecordIO(idx, path, "w")
    for k in (3, 1, 7, 0):
        w.write_idx(k, f"record {k}".encode() * (k + 1))
    w.close()
    assert open(idx).read() == "".join(
        f"{k}\t{off}\n" for k, off in zip((3, 1, 7, 0), _offsets(path)))
    r = reader.MXIndexedRecordIO(idx, path, "r")
    assert r.keys == [3, 1, 7, 0]
    for k in (7, 0, 3, 1):
        assert r.read_idx(k) == f"record {k}".encode() * (k + 1)


def _offsets(path):
    offs, pos, data = [], 0, open(path, "rb").read()
    while pos < len(data):
        offs.append(pos)
        n = int.from_bytes(data[pos + 4:pos + 8], "little") & ((1 << 29) - 1)
        pos += 8 + (n + 3) // 4 * 4
    return offs


def test_a_missing_index_is_rebuilt_by_scanning(tmp_path):
    path = str(tmp_path / "n.rec")
    w = jrec.MXRecordIO(path, "w")
    for i in range(5):
        w.write(bytes([i]) * (i + 2))
    w.close()
    r = rec.MXIndexedRecordIO(str(tmp_path / "n.idx"), path, "r")
    j = jrec.MXIndexedRecordIO(str(tmp_path / "n.idx"), path, "r")
    assert r.keys == j.keys == list(range(5)) and r.idx == j.idx
    assert [r.read_idx(k) for k in r.keys] == [bytes([i]) * (i + 2)
                                              for i in range(5)]


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(
    7, dtype=np.float32)])
def test_pack_unpack_match_the_jax_format(label):
    header = (0, label, 123456789012, 42)
    mine, theirs = rec.pack(header, b"payload"), jrec.pack(header, b"payload")
    assert mine == theirs
    for body in (mine, theirs):
        h1, s1 = rec.unpack(body)
        h2, s2 = jrec.unpack(body)
        assert s1 == s2 == b"payload"
        assert h1.flag == h2.flag and h1.id == h2.id and h1.id2 == h2.id2
        assert np.array_equal(np.asarray(h1.label), np.asarray(h2.label))


def test_pack_img_png_is_lossless_both_ways():
    img = _img(0)
    header = (0, 5.0, 1, 0)
    with CPU:
        for body in (rec.pack_img(header, img, img_fmt=".png"),
                     jrec.pack_img(header, img, img_fmt=".png")):
            h, got = rec.unpack_img(body)
            _, want = jrec.unpack_img(body)
            assert h.label == 5.0
            assert np.array_equal(got.asnumpy(), img)         # BGR in, out
            assert np.array_equal(want.asnumpy(), img)
            _, gray = rec.unpack_img(body, iscolor=0)
            _, jgray = jrec.unpack_img(body, iscolor=0)
            assert np.array_equal(gray.asnumpy(), jgray.asnumpy())
    # the payload is a PNG whose RGB is the BGR input reversed
    _, png = rec.unpack(rec.pack_img(header, img, img_fmt=".png"))
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))),
                          img[:, :, ::-1])


def test_pack_img_jpeg_reads_in_the_jax_package():
    img = np.clip(np.add.outer(np.arange(24) * 8, np.arange(32) * 5)[
        ..., None] + np.array([0, 40, 80]), 0, 255).astype(np.uint8)
    body = rec.pack_img((0, 1.0, 0, 0), img, quality=95, img_fmt=".jpg")
    _, payload = rec.unpack(body)
    assert payload[:3] == b"\xff\xd8\xff"
    _, jimg = jrec.unpack_img(body)
    with CPU:
        _, pimg = rec.unpack_img(body)
    assert np.abs(jimg.asnumpy().astype(int) - img).mean() < 3
    assert np.abs(pimg.asnumpy().astype(int) - img).mean() < 3


def test_token_shards_match_the_jax_package(tmp_path):
    tokens = np.random.RandomState(0).randint(0, 1000, 400).astype(np.int32)
    p, j = str(tmp_path / "p.rec"), str(tmp_path / "j.rec")
    assert mx.io.write_token_shard(p, tokens, 16) == \
        jmx.io.write_token_shard(j, tokens, 16)
    assert open(p, "rb").read() == open(j, "rb").read()
    kw = dict(seq_len=16, batch_size=4, shuffle=True, seed=3, num_parts=1,
              part_index=0)
    with CPU:
        mine = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                for b in mx.io.TokenRecordIter(p, **kw)]
    theirs = [(b.data[0].asnumpy(), b.label[0].asnumpy())
              for b in jmx.io.TokenRecordIter(j, **kw)]
    assert len(mine) == len(theirs) == 6
    for (a, b), (c, d) in zip(mine, theirs):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    with CPU:
        it = mx.io.TokenRecordIter(p, **kw)
        it.next()
        st = it.state_dict()
        rest = [b.data[0].asnumpy() for b in it]
        it2 = mx.io.TokenRecordIter(p, **kw)
        it2.load_state_dict(st)
        assert all(np.array_equal(a, b.data[0].asnumpy())
                   for a, b in zip(rest, it2))
    with open(str(tmp_path / "bad.rec"), "wb") as f:
        f.write(mx.native.recordio_pack([b"x" * 7]))
    with pytest.raises(ValueError, match="fixed-length token blocks"):
        mx.io.TokenRecordIter(str(tmp_path / "bad.rec"), seq_len=16)
