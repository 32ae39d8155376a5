"""The host side of the fused optimizer kernels K1/K2
(mxnet_tpu_torch/kernels/opt_step.py), on the CPU: the device table and
work split that :func:`opt_step.plan` builds, and the wrappers' table
cache and checks. The kernels themselves run only on a card
(tests/test_torch_card.py, chip_smoke.py's phase opt); here the wrappers
are pointed at the CPU with a fake launcher that records each launch."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import opt_step

MIXED = [1, 3, 4, 5, 16383, 16384, 16385, 1000 * 1001]
BLOCKS = [1, 3, 7, 264, 1056, 10 ** 9]


def _walk(p, blocks):
    """``(block, row, first element, end, path)`` of every stretch the
    kernel's ``blocks`` blocks update, walked as ``opt_step_kernel`` in
    csrc/opt_step.cu walks them: tiles dealt round-robin, each from the
    row ``first`` names."""
    rows, total = p.rows, p.n_groups
    tiles = len(p.first)
    assert tiles == -(-total // opt_step.TILE_GROUPS)
    for b in range(blocks):
        for tile in range(b, tiles, blocks):
            lo = tile * opt_step.TILE_GROUPS
            hi = min(lo + opt_step.TILE_GROUPS, total)
            k = int(p.first[tile])
            while k < len(rows) and rows["begin"][k] < hi:
                n, begin = int(rows["n"][k]), int(rows["begin"][k])
                g0 = max(lo, begin) - begin
                g1 = min(hi, begin + (n + 3) // 4) - begin
                if not rows["vec"][k]:
                    yield b, k, 4 * g0, min(4 * g1, n), "scalar"
                else:
                    whole = n // 4
                    if min(g1, whole) > g0:
                        yield b, k, 4 * g0, 4 * min(g1, whole), "vec4"
                    if g1 > whole:
                        yield b, k, 4 * whole, n, "scalar"
                k += 1


def _ptrs(n, offsets=(0, 0, 0, 0), base=1 << 20):
    """Distinct 256-byte-aligned buffers per tensor and operand, each
    shifted by its operand's byte offset."""
    return [[base + (4 * i + j) * (1 << 24) + offsets[j] for j in range(4)]
            for i in range(n)]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("sizes", [MIXED, MIXED[::-1], [0, 5, 0, 16385, 0],
                                   [1], [7] * 3000])
def test_split_covers_every_element_exactly_once(sizes, blocks):
    p = opt_step.plan(_ptrs(len(sizes)), sizes, [0.0] * len(sizes))
    nonempty = [n for n in sizes if n]
    assert list(p.rows["n"]) == nonempty
    assert p.n_groups == sum((n + 3) // 4 for n in nonempty)
    blocks = min(blocks, len(p.first))
    seen = [np.zeros(n, np.int64) for n in nonempty]
    owned = np.zeros(blocks, np.int64)
    for b, k, e0, e1, path in _walk(p, blocks):
        assert 0 <= e0 < e1 <= nonempty[k]
        seen[k][e0:e1] += 1
        owned[b] += -(-(e1 - e0) // 4)
        if path == "vec4":
            assert e0 % 4 == 0 and e1 % 4 == 0
    assert all((s == 1).all() for s in seen)
    # an even split: tiles of TILE_GROUPS groups (the last may be short)
    # dealt round-robin, so no block owns more than one tile more
    assert owned.sum() == p.n_groups
    assert owned.max() - owned.min() <= opt_step.TILE_GROUPS
    begin, n = p.rows["begin"], p.rows["n"]
    for tile, k in enumerate(p.first):
        lo = tile * opt_step.TILE_GROUPS
        assert begin[k] <= lo < begin[k] + (n[k] + 3) // 4


def test_table_rows_hold_pointers_sizes_and_weight_decays():
    sizes, wds = [5, 0, 16385], [1e-4, 0.5, 0.1]
    ptrs = _ptrs(3)
    ptrs[2][3] = 0   # SGD: no second state
    p = opt_step.plan(ptrs, sizes, wds)
    assert p.rows.dtype.itemsize == 56
    for j, field in enumerate(("w", "g", "s0", "s1")):
        assert list(p.rows[field]) == [ptrs[0][j], ptrs[2][j]]
    assert list(p.rows["begin"]) == [0, 2]
    assert list(p.rows["wd"]) == [np.float32(1e-4), np.float32(0.1)]
    assert p.n_groups == 2 + 4097


@pytest.mark.parametrize("offsets,vec", [
    ((0, 0, 0, 0), 1), ((4, 0, 0, 0), 0), ((0, 8, 0, 0), 0),
    ((0, 0, 12, 0), 0), ((0, 0, 0, 4), 0), ((16, 32, 48, 64), 1),
    ((4, 4, 4, 4), 0)])
def test_alignment_flags_follow_the_pointers(offsets, vec):
    p = opt_step.plan(_ptrs(2, offsets), [16385, 8], [0.0, 0.0])
    assert list(p.rows["vec"]) == [vec, vec]
    paths = {path for *_, path in _walk(p, 16)}
    assert paths == ({"vec4", "scalar"} if vec else {"scalar"})


def test_mixed_alignment_within_one_list():
    ptrs = _ptrs(4)
    ptrs[1][1] += 4    # one tensor's gradient 4 bytes off
    ptrs[3][0] += 8    # another's weight 8 bytes off
    p = opt_step.plan(ptrs, [64, 64, 64, 64], [0.0] * 4)
    assert list(p.rows["vec"]) == [1, 0, 1, 0]


# ---- the wrappers on the CPU, with a fake launcher -----------------------

class _FakeCard:
    """Stands in for the card: uploads stay on the CPU, the wave is
    fixed, and each launch records its arguments."""

    def __init__(self, wave=6):
        self.wave = wave
        self.launches = []
        self.uploads = []

    def launcher(self, symbol, n_floats):
        def launch(*args):
            assert len(args) == 8 + n_floats
            self.launches.append((symbol, args))
            return 0
        return launch

    def upload(self, data, device):
        self.uploads.append(data.copy())
        return torch.from_numpy(data.copy())


@pytest.fixture
def card(monkeypatch):
    fake = _FakeCard()
    monkeypatch.setattr(opt_step, "_DEVICE_TYPE", "cpu")
    monkeypatch.setattr(opt_step, "_launcher", fake.launcher)
    monkeypatch.setattr(opt_step, "_upload", fake.upload)
    monkeypatch.setattr(opt_step, "_wave", lambda symbol, dev: fake.wave)
    monkeypatch.setattr(opt_step, "_TABLES", {"opt_sgd": opt_step._Tables(),
                                              "opt_adam": opt_step._Tables()})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return fake


SHAPES = [(3,), (17, 5), (1,), (0,), (300,), (8, 8)]


def _lists(family, seed=0, shapes=SHAPES):
    rs = np.random.RandomState(seed)
    cols = 3 if family == "opt_sgd" else 4
    return [[torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in shapes] for _ in range(cols)]


def _call(family, lists, wds=None, lr=None, skip=None):
    lr = torch.tensor(1e-3) if lr is None else lr
    wds = [1e-4] * len(lists[0]) if wds is None else wds
    hyper = {"momentum": 0.9} if family == "opt_sgd" else {}
    getattr(opt_step, family)(*lists, lr, wds, skip=skip, **hyper)


def _builds(family):
    return opt_step._TABLES[family].builds


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_a_changed_pointer_size_or_weight_decay_rebuilds(card, family):
    a = _lists(family, seed=1)
    _call(family, a)
    _call(family, a)
    assert _builds(family) == 1 and len(card.launches) == 2
    symbol, args = card.launches[-1]
    assert args[2] == len(SHAPES) - 1            # the empty tensor: no row
    assert args[3] == sum((int(np.prod(s)) + 3) // 4 for s in SHAPES)
    assert args[4] == min(card.wave, -(-args[3] // opt_step.TILE_GROUPS))
    _call(family, a, wds=[1e-2] * len(SHAPES))   # weight decay
    assert _builds(family) == 2
    b = [list(col) for col in a]
    b[1][4] = b[1][4].clone()                    # one gradient's pointer
    _call(family, b)
    assert _builds(family) == 3
    c = [list(col) for col in a]
    for col in c:                                # one tensor's size
        col[4] = col[4][:299]
    _call(family, c)
    assert _builds(family) == 4
    rows = np.frombuffer(card.uploads[-1][:5 * 56].tobytes(),
                         opt_step._TABLE_DTYPE)
    assert list(rows["n"]) == [3, 85, 1, 299, 64]
    assert card.launches[-1][1][3] == 1 + 22 + 1 + 75 + 16


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_alternating_parameter_sets_both_stay_cached(card, family):
    a, b = _lists(family, seed=2), _lists(family, seed=3, shapes=[(9,), (4,)])
    for _ in range(3):
        _call(family, a)
        _call(family, b, lr=torch.tensor(2e-3))
    assert _builds(family) == 2 and len(card.launches) == 6
    many = [_lists(family, seed=10 + i, shapes=[(5,)]) for i in range(9)]
    for lists in many:                           # the oldest goes first
        _call(family, lists)
    assert len(opt_step._TABLES[family].by_key) == \
        opt_step.TABLES_PER_FAMILY


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_a_cache_hit_still_refuses_what_the_check_refuses(card, family):
    """Each refused set shares its pointers with a set the cache holds;
    the error is the one the full check gives."""
    good = _lists(family, seed=4)
    _call(family, good)
    builds = _builds(family)
    i = 5                                        # the (8, 8) tensor

    def variant(col, t):
        out = [list(c) for c in good]
        out[col][i] = t
        return out

    w, g, m = good[0][i], good[1][i], good[2][i]
    cases = [
        (variant(0, w.view(torch.int32)), ValueError, "float32 only"),
        (variant(1, g.view(torch.int32)), ValueError, "float32 only"),
        (variant(2, m.t()), ValueError, "must be contiguous"),
        (variant(0, w.t()), ValueError, "must be contiguous"),
        (variant(1, g.view(4, 16)), ValueError, "shapes"),
        (variant(2, m.view(64)), ValueError, "shapes"),
        (variant(1, torch.empty((8, 8), device="meta")),
         kernels.DeviceError, "one CUDA card"),
    ]
    for lists, err, match in cases:
        with pytest.raises(err, match=match):
            _call(family, lists)
    with pytest.raises(ValueError, match="lr and skip"):
        _call(family, good, lr=torch.tensor(1e-3, dtype=torch.float64))
    with pytest.raises(ValueError, match="lr and skip"):
        _call(family, good, skip=torch.zeros(2))
    with pytest.raises(ValueError, match="unequal"):
        _call(family, [col[:-1] if j == 1 else col
                       for j, col in enumerate(good)])
    with pytest.raises(ValueError, match="share one buffer"):
        _call(family, variant(2, w))
    n = len(card.launches)
    _call(family, good)                          # still cached, still taken
    assert _builds(family) == builds and len(card.launches) == n + 1


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_only_a_gradient_that_is_not_contiguous_is_copied(card, family):
    lists = _lists(family, seed=5)
    fn = getattr(opt_step, family)
    copies = fn.copies
    _call(family, lists)
    assert fn.copies == copies
    strided = torch.zeros(8, 16)[:, ::2]
    lists[1][5] = strided
    _call(family, lists)
    assert fn.copies == copies + 1
    with pytest.raises(ValueError, match="must be contiguous"):
        lists[1][5] = lists[1][5].contiguous()
        lists[0][5] = torch.zeros(8, 16)[:, ::2]
        _call(family, lists)


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_launches_count_tensors_by_path(card, family):
    fn = getattr(opt_step, family)
    before = dict(fn.tensors_by_path)
    n = 64
    lists = _lists(family, seed=6, shapes=[(n,)] * 3)
    buf = torch.zeros(n + 1)
    lists[1][2] = buf[1:1 + n]                   # one gradient 4 bytes off
    _call(family, lists)
    assert fn.tensors_by_path["vec4"] - before["vec4"] == 2
    assert fn.tensors_by_path["scalar"] - before["scalar"] == 1


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_dispatch_takes_the_plain_version_for_cpu_and_refuses_a_mix(family):
    lists = _lists(family, seed=7)
    launches = getattr(opt_step, family).launches
    _call_dispatch = lambda ls: kernels.dispatch(  # noqa: E731
        family, *ls, torch.tensor(1e-3), [0.0] * len(ls[0]),
        **({"momentum": 0.9} if family == "opt_sgd" else {}))
    _call_dispatch(lists)
    assert getattr(opt_step, family).launches == launches
    lists[1][2] = torch.empty(1, device="meta")
    with pytest.raises(kernels.DeviceError, match="devices"):
        _call_dispatch(lists)
