"""The multi-tensor 2-bit kernels' host side and plain versions
(mxnet_tpu_torch/kernels/twobit.py: ``twobit_compress_multi``, and
``twobit_decompress`` over a range of the wire), on the CPU: the plain versions bit for bit
against the JAX package's ``_xla_compress`` / ``_xla_decompress`` and its
Pallas kernels in interpret mode, written into flat slots as the dist
kvstore lays them out; the device table and tile split that
:func:`twobit.plan` builds, walked as ``csrc/twobit.cu`` walks it; and the
wrapper's table cache and checks, pointed at the CPU with a fake launcher.
The kernels themselves run only on a card (tests/test_torch_card.py,
chip_smoke.py's phase twobit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import twobit as jtwobit
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import opt_step, twobit

ODD = [(1,), (2,), (3,), (127,), (4097,), (33, 5), (0,), (16,), (2, 8, 3)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _slots(shapes):
    """Flat residual and code buffers with one slot per shape, each
    starting at a multiple of 16 elements (the kvstore's layout)."""
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.concatenate([[0], np.cumsum([-(-n // 16) * 16
                                           for n in sizes])]).astype(int)
    return sizes, offs


def _grads(shapes, seed, thr):
    rs = np.random.RandomState(seed)
    out = []
    for s in shapes:
        g = (rs.randn(*s) * thr * 2).astype(np.float32)
        edge = np.array([thr, -thr, np.nan, np.nextafter(np.float32(thr), 0)],
                        np.float32)
        g.reshape(-1)[:min(g.size, 4)] = edge[:min(g.size, 4)]
        out.append(g)
    return out


@pytest.mark.parametrize("thr", [0.5, 0.1, 1e-3])
def test_plain_multi_compress_is_bit_exact_to_xla_and_pallas(thr):
    """Each gradient's codes land in its slot of the flat code buffer and
    its new residual in its slot of the flat residual buffer, equal bit
    for bit to the JAX package's per-tensor functions; the padding
    between slots stays zero."""
    sizes, offs = _slots(ODD)
    rs = np.random.RandomState(7)
    res0 = (rs.randn(offs[-1]) * thr).astype(np.float32)
    for k, n in enumerate(sizes):          # padding is zero in the store
        res0[offs[k] + n:offs[k + 1]] = 0.0
    grads = _grads(ODD, seed=3, thr=thr)
    residual = torch.from_numpy(res0.copy())
    wire = torch.zeros(offs[-1], dtype=torch.int8)
    rviews = [residual[o:o + n].view(s) for o, n, s in zip(offs, sizes, ODD)]
    cviews = [wire[o:o + n] for o, n in zip(offs, sizes)]
    kernels.dispatch("twobit_compress_multi",
                     [torch.from_numpy(g) for g in grads], rviews, cviews, thr)
    for k, (g, n) in enumerate(zip(grads, sizes)):
        r = res0[offs[k]:offs[k] + n].reshape(g.shape)
        want = [jtwobit._xla_compress(jnp.asarray(g), jnp.asarray(r), thr)]
        if n:
            want.append(jtwobit._kernel_compress(jnp.asarray(g),
                                                 jnp.asarray(r), thr,
                                                 interpret=True))
        for jc, jr in want:
            np.testing.assert_array_equal(cviews[k].numpy(),
                                          np.asarray(jc).reshape(-1))
            np.testing.assert_array_equal(_bits(rviews[k].numpy()),
                                          _bits(np.asarray(jr)))
        assert not wire[offs[k] + n:offs[k + 1]].any()
        assert not residual[offs[k] + n:offs[k + 1]].any()


@pytest.mark.parametrize("thr", [0.5, 0.05])
@pytest.mark.parametrize("lo,hi", [(0, None), (16, 4113), (1, 200), (5, 6)])
def test_plain_flat_decompress_is_bit_exact_to_xla_and_pallas(thr, lo, hi):
    """Summed int8 codes of a range of the wire (a run of buckets) to
    float32, bit for bit against the JAX package."""
    rs = np.random.RandomState(lo + 3)
    wire = rs.randint(-2, 3, 5000).astype(np.int8)
    c = wire[lo:hi]
    got = kernels.dispatch("twobit_decompress", torch.from_numpy(c), thr)
    assert got.dtype == torch.float32 and got.shape == c.shape
    for want in (jtwobit._xla_decompress(jnp.asarray(c), thr),
                 jtwobit._kernel_decompress(jnp.asarray(c), thr,
                                            interpret=True)):
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(np.asarray(want)))


# ---- the table and the split ---------------------------------------------

BLOCKS = [1, 3, 7, 264, 2112, 10 ** 9]
MIXED = [1, 15, 16, 511, 512, 513, 4095, 4096, 4097, 768 * 768, 2, 768]


def _walk(p, blocks):
    """``(block, row, first element, end, path)`` of every group the
    kernel's ``blocks`` blocks handle, as ``twobit_compress_multi_kernel``
    walks them: tiles dealt round-robin, warp ``i`` of a block group ``i``
    of the tile, its row found by walking on from ``first``."""
    rows, total = p.rows, p.n_groups
    tiles = len(p.first)
    assert tiles == -(-total // twobit.TILE_GROUPS)
    ends = rows["begin"] + (rows["n"] + twobit.GROUP - 1) // twobit.GROUP
    for b in range(blocks):
        for tile in range(b, tiles, blocks):
            for i in range(twobit.TILE_GROUPS):
                grp = tile * twobit.TILE_GROUPS + i
                if grp >= total:
                    break
                k = int(p.first[tile])
                while grp >= ends[k]:
                    k += 1
                n = int(rows["n"][k])
                e0 = (grp - int(rows["begin"][k])) * twobit.GROUP
                e1 = min(e0 + twobit.GROUP, n)
                vec = rows["vec"][k] and e1 - e0 == twobit.GROUP
                yield b, k, e0, e1, "vec16" if vec else "scalar"


def _ptrs(n, offsets=(0, 0, 0), base=1 << 20):
    """Distinct 256-byte-aligned buffers per tensor and operand, each
    shifted by its operand's byte offset."""
    return [[base + (3 * i + j) * (1 << 24) + offsets[j] for j in range(3)]
            for i in range(n)]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("sizes", [MIXED, MIXED[::-1], [0, 5, 0, 4097, 0],
                                   [1], [16] * 600])
def test_split_covers_every_element_exactly_once(sizes, blocks):
    p = twobit.plan(_ptrs(len(sizes)), sizes)
    nonempty = [n for n in sizes if n]
    assert list(p.rows["n"]) == nonempty
    assert p.n_groups == sum(-(-n // twobit.GROUP) for n in nonempty)
    blocks = min(blocks, len(p.first))
    seen = [np.zeros(n, np.int64) for n in nonempty]
    owned = np.zeros(blocks, np.int64)
    for b, k, e0, e1, path in _walk(p, blocks):
        assert 0 <= e0 < e1 <= nonempty[k]
        seen[k][e0:e1] += 1
        owned[b] += 1
        if path == "vec16":
            assert e0 % twobit.GROUP == 0 and e1 - e0 == twobit.GROUP
    assert all((s == 1).all() for s in seen)
    # tiles of TILE_GROUPS groups (the last may be short) dealt
    # round-robin: no block owns more than one tile more than another
    assert owned.sum() == p.n_groups
    assert owned.max() - owned.min() <= twobit.TILE_GROUPS
    begin, n = p.rows["begin"], p.rows["n"]
    for tile, k in enumerate(p.first):
        lo = tile * twobit.TILE_GROUPS
        assert begin[k] <= lo < begin[k] + -(-n[k] // twobit.GROUP)


def test_table_rows_hold_pointers_and_sizes():
    sizes = [5, 0, 4097]
    ptrs = _ptrs(3)
    p = twobit.plan(ptrs, sizes)
    assert p.rows.dtype.itemsize == 48
    for j, field in enumerate(("grad", "res", "codes")):
        assert list(p.rows[field]) == [ptrs[0][j], ptrs[2][j]]
    assert list(p.rows["n"]) == [5, 4097]
    assert list(p.rows["begin"]) == [0, 1]
    assert p.n_groups == 1 + 9        # groups of 512 elements
    assert list(p.first) == [0, 1]    # tiles of 8 groups


@pytest.mark.parametrize("offsets,vec", [
    ((0, 0, 0), 1), ((4, 0, 0), 0), ((0, 8, 0), 0), ((0, 0, 1), 0),
    ((16, 32, 48), 1), ((12, 12, 12), 0)])
def test_alignment_flags_follow_the_pointers(offsets, vec):
    p = twobit.plan(_ptrs(2, offsets), [4097, 40])
    assert list(p.rows["vec"]) == [vec, vec]
    paths = {path for *_, path in _walk(p, 4)}
    assert paths == ({"vec16", "scalar"} if vec else {"scalar"})


# ---- the wrapper on the CPU, with a fake launcher ------------------------

class _FakeCard:
    """Stands in for the card: uploads stay on the CPU, the wave is
    fixed, and each launch records its arguments."""

    def __init__(self, wave=6):
        self.wave = wave
        self.launches = []
        self.uploads = []

    def launcher(self, symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            self.launches.append((symbol, args))
            return 0
        return launch

    def upload(self, data, device):
        self.uploads.append(data.copy())
        return torch.from_numpy(data.copy())


@pytest.fixture
def card(monkeypatch):
    fake = _FakeCard()
    monkeypatch.setattr(twobit, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(twobit, "_launcher", fake.launcher)
    monkeypatch.setattr(opt_step, "_upload", fake.upload)
    monkeypatch.setattr(twobit, "_wave", lambda which, dev: fake.wave)
    monkeypatch.setattr(twobit, "_TABLES", twobit._Tables())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return fake


SHAPES = [(3,), (17, 5), (1,), (0,), (300,), (8, 8)]


def _multi(shapes=SHAPES, seed=0):
    sizes, offs = _slots(shapes)
    rs = np.random.RandomState(seed)
    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in shapes]
    residual = torch.zeros(offs[-1])
    wire = torch.zeros(offs[-1], dtype=torch.int8)
    return (grads, [residual[o:o + n].view(s)
                    for o, n, s in zip(offs, sizes, shapes)],
            [wire[o:o + n] for o, n in zip(offs, sizes)])


def test_a_known_key_set_reuses_its_table(card):
    grads, res, codes = _multi()
    fn = twobit.twobit_compress_multi
    launches = fn.launches
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    assert twobit._TABLES.builds == 1 and len(card.launches) == 2
    assert fn.launches == launches + 2
    symbol, args = card.launches[-1]
    assert symbol == "mxtt_twobit_compress_multi"
    assert args[2] == len(SHAPES) - 1            # the empty tensor: no row
    assert args[3] == sum(-(-int(np.prod(s)) // twobit.GROUP)
                          for s in SHAPES)
    assert args[4] == min(card.wave, -(-args[3] // twobit.TILE_GROUPS))
    assert args[5] == 0.5
    rows = np.frombuffer(card.uploads[-1][:5 * 48].tobytes(),
                         twobit._ROW_DTYPE)
    assert list(rows["n"]) == [3, 85, 1, 300, 64]
    assert list(rows["grad"]) == [g.data_ptr() for g in grads if g.numel()]
    assert list(rows["codes"]) == [c.data_ptr() for c in codes if c.numel()]
    grads[4] = grads[4].clone()                  # a new gradient address
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    assert twobit._TABLES.builds == 2


def test_the_check_refuses_what_the_kernel_does_not_take(card):
    grads, res, codes = _multi()
    i = 5                                        # the (8, 8) tensor

    def variant(col, t):
        out = [list(grads), list(res), list(codes)]
        out[col][i] = t
        return out

    cases = [
        (variant(0, grads[i].double()), ValueError, "float32"),
        (variant(1, res[i].double()), ValueError, "float32"),
        (variant(2, codes[i].to(torch.int32)), ValueError, "int8"),
        (variant(0, grads[i][:4]), ValueError, "sizes"),
        (variant(1, torch.zeros(16, 8)[:, ::2]), ValueError,
         "must be contiguous"),
        (variant(2, codes[0]), ValueError, "sizes"),
        (variant(1, res[4][:64]), ValueError, "share one buffer"),
        (variant(0, torch.empty((8, 8), device="meta")),
         kernels.DeviceError, "one CUDA card"),
    ]
    for lists, err, match in cases:
        with pytest.raises(err, match=match):
            twobit.twobit_compress_multi(*lists, 0.5)
    with pytest.raises(ValueError, match="unequal"):
        twobit.twobit_compress_multi(grads, res[:-1], codes, 0.5)
    assert card.launches == []


def test_only_a_gradient_that_is_not_contiguous_is_copied(card):
    grads, res, codes = _multi()
    fn = twobit.twobit_compress_multi
    copies, paths = fn.copies, dict(fn.tensors_by_path)
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    assert fn.copies == copies
    grads[5] = torch.zeros(8, 16)[:, ::2]
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    assert fn.copies == copies + 1
    # every row aligned (fresh CPU tensors and 16-element slots)
    assert fn.tensors_by_path["vec16"] - paths["vec16"] == 2 * 5
    buf = torch.zeros(301)
    grads[4] = buf[1:]                           # 4 bytes off
    twobit.twobit_compress_multi(grads, res, codes, 0.5)
    assert fn.tensors_by_path["scalar"] - paths["scalar"] == 1


def test_decompress_launch_and_its_path(card):
    """int8 codes take the tiled kernel (one wave at most, "vec16" when
    codes and output are 16-byte aligned, else "scalar"), int32 codes the
    grid-stride loop; one launch each, counted by path."""
    fn = twobit.twobit_decompress
    before = dict(fn.launches_by_path)
    wire = torch.zeros(4096 * 3 + 7, dtype=torch.int8)
    out = twobit.twobit_decompress(wire, 0.5)
    assert out.dtype == torch.float32 and out.shape == wire.shape
    symbol, args = card.launches[-1]
    assert symbol == "mxtt_twobit_decompress"
    # (codes, code bytes, out, dtype code, n, thr, vec, blocks, stream)
    assert args[1] == 1 and args[3] == 0 and args[4] == wire.numel() \
        and args[6] == 1
    groups = -(-wire.numel() // twobit.GROUP)
    assert args[7] == min(card.wave, -(-groups // twobit.TILE_GROUPS))
    twobit.twobit_decompress(wire[1:], 0.5)
    assert card.launches[-1][1][6] == 0
    twobit.twobit_decompress(wire.to(torch.int32), 0.5)
    assert card.launches[-1][1][1] == 4
    assert fn.launches_by_path == {p: before[p] + 1 for p in before}
    with pytest.raises(ValueError, match="int8 or int32"):
        twobit.twobit_decompress(wire.to(torch.int16), 0.5)
    # float16 and bfloat16 outputs since fault C4's repair; float64 is
    # still refused
    half = twobit.twobit_decompress(wire, 0.1, dtype="float16")
    assert half.dtype == torch.float16
    assert card.launches[-1][1][3] == 1 and card.launches[-1][1][5] == \
        twobit.round_threshold(0.1, torch.float16)
    with pytest.raises(ValueError, match="writes float32, float16 or "
                                         "bfloat16"):
        twobit.twobit_decompress(wire, 0.5, dtype="float64")


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """``kernels.dispatch`` sends CPU tensors to the plain versions; the
    CUDA wrappers refuse them; no launch is counted."""
    kernels.reset_launch_counts()
    grads, res, codes = _multi(seed=9)
    kernels.dispatch("twobit_compress_multi", grads, res, codes, 0.5)
    kernels.dispatch("twobit_decompress", torch.cat(codes), 0.5)
    counts = kernels.launch_counts()
    for family in ("twobit_compress_multi", "twobit_decompress",
                   "twobit_decompress.vec16", "twobit_decompress.scalar",
                   "twobit_decompress.int32"):
        assert counts[family] == 0
    with pytest.raises(ValueError, match="CUDA"):
        twobit.twobit_decompress(torch.cat(codes), 0.5)
    with pytest.raises(kernels.DeviceError, match="one CUDA card"):
        twobit.twobit_compress_multi(grads, res, codes, 0.5)
    for family in ("twobit_compress_multi", "twobit_decompress"):
        e = kernels.entry(family)
        assert e.replaces.startswith("mxnet_tpu/kernels/twobit.py:_kernel_")
        assert "bit-exact" in e.tolerance
