"""The port's kernel modules held against the JAX package, on the CPU.

For each of the port's five kernels, the plain PyTorch
version (what a CPU tensor runs, and what the CUDA kernel is held to on the
card by ``chip_smoke.py``) must be bit-identical — values AND dtypes — to
the reference's jnp formulation and to its Pallas kernel run in interpret
mode, on the same seeded numpy inputs: empty, all-masked, single-bucket and
larger shapes. The gate's tier rule is covered too: the CPU tier, the
counters, a CUDA-tier launch error that raises (the launch function is
monkeypatched) and is never memoized, and the ``fallback`` tier for an
ineligible call.
"""

import ctypes
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_cypher.backend.tpu import bucketing as RB
from tpu_cypher.backend.tpu import jit_ops as RJ
from tpu_cypher.backend.tpu.pallas import aggregate as RPA
from tpu_cypher.backend.tpu.pallas import dispatch as RD
from tpu_cypher.backend.tpu.pallas import expand as RPE
from tpu_cypher.backend.tpu.pallas import frontier as RPF
from tpu_cypher.backend.tpu.pallas import intersect as RPI

from tpu_cypher_torch import errors as PERR
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import _build as PB
from tpu_cypher_torch.backend.cuda.hopper import aggregate as PA
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.hopper import expand as PE
from tpu_cypher_torch.backend.cuda.hopper import frontier as PF
from tpu_cypher_torch.backend.cuda.hopper import intersect as PI

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (name, rows, mask density) — the reference's fuzz-corpus shape classes
SHAPES = [
    ("empty", 0, 0.0),
    ("all_masked", 300, 0.0),
    ("single_bucket", 9, 0.9),
    ("dense", 1000, 0.85),
    ("larger", 5000, 0.5),
]


@pytest.fixture(autouse=True)
def _clean():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


@pytest.fixture
def interpret_mode():
    """The reference's Pallas kernels run interpreted on the CPU; the mode
    is restored afterwards."""
    RD.MODE.set("interpret")
    yield
    RD.MODE.reset()
    RD.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(want, got, what):
    """Bit-identical: dtype, shape and every bit (floats via int64 view)."""
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert w.dtype == g.dtype, (what, w.dtype, g.dtype)
    assert w.shape == g.shape, (what, w.shape, g.shape)
    if w.dtype == np.float64:
        w, g = w.view(np.int64), g.view(np.int64)
    assert np.array_equal(w, g), what


def _csr_case(shape_name, n, density):
    rng = np.random.default_rng(zlib.crc32(shape_name.encode()))
    n_nodes = max(n // 2, 4)
    deg = rng.integers(0, 6, n_nodes).astype(np.int64)
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n_edges = int(deg.sum())
    ci = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    eo = rng.integers(0, 10**9, n_edges).astype(np.int64)
    pos = rng.integers(0, n_nodes, n).astype(np.int64)
    present = rng.random(n) < density
    return rp, ci, eo, pos, present


# ---------------------------------------------------------------------------
# expand_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name,n,density", SHAPES)
def test_expand_plain_matches_reference(interpret_mode, shape_name, n, density):
    rp, ci, eo, pos, present = _csr_case(shape_name, n, density)
    r_deg, r_tot = RJ.expand_degrees_total(
        jnp.asarray(rp), jnp.asarray(pos), jnp.asarray(present)
    )
    p_deg, p_tot = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    _same(r_deg, p_deg, "deg")
    _same(r_tot, p_tot, "total")
    total = int(r_tot)
    sizes = (
        {total, RB.round_up_pow2(total, 32), total * 2 + 32} if total else {0}
    )
    for size in sizes:
        args_r = (jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(eo),
                  jnp.asarray(pos), r_deg, r_tot)
        args_p = (_t(rp), _t(ci), _t(eo), _t(pos), p_deg, total)
        want_jnp = RJ.expand_materialize_counted(*args_r, size=size)
        want_pallas = RPE.expand_materialize_counted(*args_r, size=size)
        got_plain = PJ.expand_materialize_counted(*args_p, size)
        got_gate = PE.expand_materialize_counted(*args_p, size=size)
        for nm, w, wp, g, gg in zip(
            ("row", "nbr", "orig", "live"), want_jnp, want_pallas, got_plain, got_gate
        ):
            _same(w, g, (shape_name, size, nm, "jnp"))
            _same(wp, g, (shape_name, size, nm, "pallas-interpret"))
            _same(w, gg, (shape_name, size, nm, "gate"))
    counts = PD.use_counts()["expand_rows"]
    assert counts == {"kernel": 0, "plain": len(sizes), "fallback": 0}
    if total:
        assert RD.use_counts()["expand_rows"]["pallas"] == len(sizes)


@pytest.mark.parametrize("shape_name,n,density", SHAPES)
def test_expand_frontier_state_matches_pallas_wrapper(shape_name, n, density):
    """The kernel's inputs are built by torch ops exactly as the TPU
    wrapper builds them (int32 starts and the leading-zero cumsum)."""
    rp, _, _, pos, present = _csr_case(shape_name, n, density)
    deg, _ = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    cum, starts = PE.frontier_state(_t(rp), _t(pos), deg)
    r_deg = jnp.asarray(deg.numpy())
    _same(jnp.take(jnp.asarray(rp), jnp.asarray(pos)).astype(jnp.int32), starts, "starts")
    _same(
        jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(r_deg).astype(jnp.int32)]),
        cum, "cum",
    )


def test_repeat_padding_matches_jnp():
    """``jnp.repeat(..., total_repeat_length=)`` pads with the array's last
    value; the port writes that tail explicitly."""
    x = np.array([4, 5, 6], np.int64)
    for counts in ([1, 1, 0], [1, 0, 1], [0, 0, 0], [2, 1, 3]):
        c = np.array(counts, np.int64)
        for total in (int(c.sum()), int(c.sum()) + 3):
            want = jnp.repeat(jnp.asarray(x), jnp.asarray(c), total_repeat_length=total)
            _same(want, PJ._repeat_padded(_t(x), _t(c), total), (counts, total))


def _csr_from_degrees(rng, deg):
    deg = np.asarray(deg, np.int64)
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n_edges = int(deg.sum())
    ci = rng.integers(0, len(deg), n_edges).astype(np.int32)
    eo = rng.integers(0, 10**9, n_edges).astype(np.int64)
    return rp, ci, eo


def _tile_case(name):
    """(rp, ci, eo, pos, present, sizes beyond the total) for the shapes
    that cross the row kernel's tiles of ``PE.TILE_ITEMS`` merge items."""
    tile = PE.TILE_ITEMS
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "absent_runs":
        # absent frontier rows (degree 0) in runs longer than a tile; the
        # first holds a whole tile of row starts wherever the tiles fall
        rp, ci, eo = _csr_from_degrees(rng, rng.integers(0, 6, 3000))
        f = 4 * tile + 1500
        pos = rng.integers(0, 3000, f).astype(np.int64)
        present = rng.random(f) < 0.9
        present[700:700 + 2 * tile + 100] = False
        present[3 * tile:4 * tile + 300] = False
        return rp, ci, eo, pos, present, (5,)
    if name == "hub_row":
        # one row whose degree spans several tiles
        deg = rng.integers(0, 4, 400)
        deg[7] = 3 * tile + 77
        rp, ci, eo = _csr_from_degrees(rng, deg)
        pos = rng.integers(0, 400, 500).astype(np.int64)
        pos[250] = 7
        present = rng.random(500) < 0.9
        present[250] = True
        return rp, ci, eo, pos, present, (3,)
    # lanes plus row starts off the tile boundary, with pads past it
    rp, ci, eo = _csr_from_degrees(rng, rng.integers(1, 5, 2000))
    pos = rng.integers(0, 2000, 1501).astype(np.int64)
    return rp, ci, eo, pos, np.ones(1501, bool), (2 * tile + 3, 1)


TILE_SHAPES = ["absent_runs", "hub_row", "off_tile"]


def _expand_sizes(total, extra=()):
    if not total:
        return [0]
    return sorted({total, RB.round_up_pow2(total, 32), total * 2 + 32}
                  | {total + e for e in extra})


@pytest.mark.parametrize("shape_name", TILE_SHAPES)
def test_expand_tile_shapes_match_reference(interpret_mode, shape_name):
    """Frontiers that cross the kernel's tiles: the plain version and the
    gate equal the reference's jnp and Pallas (interpret) formulations bit
    for bit, pad lanes included."""
    rp, ci, eo, pos, present, extra = _tile_case(shape_name)
    r_deg, r_tot = RJ.expand_degrees_total(
        jnp.asarray(rp), jnp.asarray(pos), jnp.asarray(present)
    )
    p_deg, p_tot = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    _same(r_deg, p_deg, "deg")
    total = int(r_tot)
    if shape_name == "off_tile":
        assert (total + len(pos)) % PE.TILE_ITEMS
    sizes = _expand_sizes(total, extra)
    for size in sizes:
        args_r = (jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(eo),
                  jnp.asarray(pos), r_deg, r_tot)
        args_p = (_t(rp), _t(ci), _t(eo), _t(pos), p_deg, total)
        want_jnp = RJ.expand_materialize_counted(*args_r, size=size)
        want_pallas = RPE.expand_materialize_counted(*args_r, size=size)
        got_plain = PJ.expand_materialize_counted(*args_p, size)
        got_gate = PE.expand_materialize_counted(*args_p, size=size)
        for nm, w, wp, g, gg in zip(
            ("row", "nbr", "orig", "live"), want_jnp, want_pallas, got_plain, got_gate
        ):
            _same(w, g, (shape_name, size, nm, "jnp"))
            _same(wp, g, (shape_name, size, nm, "pallas-interpret"))
            _same(w, gg, (shape_name, size, nm, "gate"))
    assert PD.use_counts()["expand_rows"] == {"kernel": 0, "plain": len(sizes), "fallback": 0}


class _Unreadable:
    """An ``eo`` that fails the test on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"eo.{name} was read")

    def __getitem__(self, idx):
        raise AssertionError("eo was indexed")


class _ExpandKernelEmulation:
    """``expand_rows.cu`` in torch, reading the wrapper's raw ctypes
    arguments as its two kernels read them. The state launch: starts, the
    degree scan, and the partition points as its rows write them (row r
    writes r + 1 at every tile boundary k * tile in (m(r), m(r + 1)], with
    m(r) = min(cum[r], live) + r its merge position), checked against the
    closed rule (parts[k] = the row starts merged before boundary k). The
    row launch: per tile, its window of row starts and its lanes, each
    lane's row found in the window, then the gathers; pad lanes zero."""

    def __init__(self):
        self.windows = []  # (lanes, row starts) of each tile

    def expand_rows_scratch_bytes(self, device):
        return 16

    def expand_state_launch(self, rp, pos, deg, nrows, live, ntiles, tile, starts,
                            cum, parts, scratch, stream):
        assert nrows > 0 and live > 0 and ntiles == -(-(live + nrows) // tile)
        p = _raw(pos, ctypes.c_int64, nrows)
        d = _raw(deg, ctypes.c_int64, nrows)
        hi = torch.cumsum(d, 0)
        lo = hi - d
        r = torch.arange(nrows)
        m_lo = torch.clamp(lo, max=live) + r
        m_hi = torch.clamp(hi, max=live) + r + 1
        k_end = torch.where(r + 1 < nrows, m_hi // tile, torch.full_like(r, ntiles))
        k_start = m_lo // tile + 1
        n = torch.clamp(k_end - k_start + 1, min=0)
        first = torch.repeat_interleave(k_start, n)
        offset = torch.arange(int(n.sum())) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        ks = first + offset
        out = torch.full((ntiles + 1,), -1, dtype=torch.int64)
        out[0] = 0
        out[ks] = torch.repeat_interleave(r + 1, n)
        assert torch.equal(torch.bincount(ks, minlength=ntiles + 1)[1:],
                           torch.ones(ntiles, dtype=torch.int64)), "a boundary written twice or never"
        bounds = torch.clamp(torch.arange(ntiles + 1) * tile, max=live + nrows)
        assert torch.equal(out, torch.searchsorted(m_lo, bounds)), "parts break the merge rule"
        rp_t = _raw(rp, ctypes.c_int32, int(p.max()) + 1)
        _store(starts, rp_t[p])
        _store(cum, torch.cat([torch.zeros(1, dtype=torch.int64), hi]).to(torch.int32))
        _store(parts, out.to(torch.int32))
        return 0

    def expand_rows_launch(self, cum, starts, parts, nrows, live, ntiles, tile, size,
                           ci, eo, row, nbr, orig, live_out, stream):
        assert (eo is None) == (orig is None) and 0 <= live <= size
        i64 = torch.int64
        rows = torch.zeros(size, dtype=i64)
        edges = torch.zeros(size, dtype=i64)
        if live:
            c = _raw(cum, ctypes.c_int32, nrows + 1).to(i64)
            st = _raw(starts, ctypes.c_int32, nrows).to(i64)
            pt = _raw(parts, ctypes.c_int32, ntiles + 1).to(i64).tolist()
            items = live + nrows
            for t in range(ntiles):
                d0, d1 = t * tile, min((t + 1) * tile, items)
                b0, b1 = pt[t], pt[t + 1]
                a0, a1 = d0 - b0, d1 - b1
                assert 0 <= b1 - b0 <= tile and a0 <= a1 <= live
                self.windows.append((a1 - a0, b1 - b0))
                lanes = torch.arange(a0, a1)
                win = torch.searchsorted(c[b0:b1], lanes, right=True)
                r = b0 - 1 + win
                assert (r >= 0).all() and (r < nrows).all()
                rows[a0:a1] = r
                edges[a0:a1] = st[r] + lanes - c[r]
        alive = torch.arange(size) < live
        n_edges = int(edges.max()) + 1 if size else 0
        nbr_v = torch.where(alive, _raw(ci, ctypes.c_int32, n_edges).to(i64)[edges], 0)
        _store(row, rows)
        _store(nbr, nbr_v)
        if eo is not None:
            _store(orig, torch.where(alive, _raw(eo, ctypes.c_int64, n_edges)[edges], 0))
        _store(live_out, alive)
        return 0


EXPAND_SHAPES = [s[0] for s in SHAPES] + TILE_SHAPES


def _expand_case(shape_name):
    if shape_name in TILE_SHAPES:
        return _tile_case(shape_name)
    rp, ci, eo, pos, present = _csr_case(*[s for s in SHAPES if s[0] == shape_name][0])
    return rp, ci, eo, pos, present, ()


@pytest.mark.parametrize("tile", [16, PE.TILE_ITEMS])
@pytest.mark.parametrize("shape_name", EXPAND_SHAPES)
def test_expand_kernel_arguments_emulated_match_plain(monkeypatch, shape_name, tile):
    """The wrapper's ctypes arguments, read by a torch emulation of the two
    kernels' partition rule and per-tile windows, give the plain version's
    (row, nbr, orig, live) bit for bit, with and without orig, at the
    kernel's tile and at a 16-item one that makes every shape cross many
    tiles. The kernels themselves run only on the card
    (``chip_smoke.py`` holds them to the plain version there)."""
    emu = _ExpandKernelEmulation()
    monkeypatch.setattr(PE, "_lib", lambda: emu)
    monkeypatch.setattr(PE, "TILE_ITEMS", tile)
    monkeypatch.setattr(PE._build, "stream", lambda dev: 0)
    monkeypatch.setattr(PE._build, "scratch_ptr", lambda kernel, dev, nbytes, stream: 0)
    rp, ci, eo, pos, present, extra = _expand_case(shape_name)
    deg, tot = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    total = int(tot)
    for size in _expand_sizes(total, extra):
        args = (_t(rp), _t(ci), _t(eo), _t(pos), deg, total, size)
        want = PJ.expand_materialize_counted(*args)
        for nm, w, g in zip(("row", "nbr", "orig", "live"), want, PE._launch(*args, True)):
            _same(w.numpy(), g, (shape_name, tile, size, nm))
        got = PE._launch(*args[:2], _Unreadable(), *args[3:], False)
        for nm, w, g in zip(("row", "nbr", "live"), (want[0], want[1], want[3]),
                            (got[0], got[1], got[3])):
            _same(w.numpy(), g, (shape_name, tile, size, nm, "without orig"))
        assert got[2].dtype == torch.int64 and got[2].shape == (0,)
    if shape_name == "absent_runs":
        assert any(lanes == 0 and starts == tile for lanes, starts in emu.windows)
    if shape_name == "hub_row":
        assert any(lanes == tile and starts == 0 for lanes, starts in emu.windows)


@pytest.mark.parametrize("shape_name", ["dense", "hub_row"])
def test_expand_without_orig_leaves_eo_unread(shape_name):
    """``with_orig=False``: the plain version and the gate give the same
    row, nbr and live as with orig, an empty int64 orig, and never touch
    ``eo``."""
    rp, ci, eo, pos, present, extra = _expand_case(shape_name)
    deg, tot = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    total = int(tot)
    for size in _expand_sizes(total, extra):
        want = PJ.expand_materialize_counted(_t(rp), _t(ci), _t(eo), _t(pos), deg, total, size)
        for got in (
            PJ.expand_materialize_counted(_t(rp), _t(ci), _Unreadable(), _t(pos), deg,
                                          total, size, with_orig=False),
            PE.expand_materialize_counted(_t(rp), _t(ci), _Unreadable(), _t(pos), deg,
                                          total, size=size, with_orig=False),
        ):
            for i in (0, 1, 3):
                _same(want[i].numpy(), got[i], (shape_name, size, i))
            assert got[2].dtype == torch.int64 and got[2].shape == (0,)


# ---------------------------------------------------------------------------
# frontier_deg_sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name,n,density", SHAPES)
def test_frontier_plain_matches_reference(interpret_mode, shape_name, n, density):
    rp, _, _, pos, present = _csr_case(shape_name, n, density)
    args_r = (jnp.asarray(rp), jnp.asarray(pos), jnp.asarray(present))
    args_p = (_t(rp), _t(pos), _t(present))
    want = RPF._csr_deg_sum_jnp(*args_r)
    got = PF.deg_sum_plain(*args_p)
    _same(want, got, "plain")
    _same(want, PF.csr_frontier_degree_sum(*args_p), "gate")
    if n:
        _same(want, RPF._csr_deg_sum_pallas(*args_r, interpret=True), "pallas")
    assert PD.use_counts()["frontier_deg_sum"] == {
        "kernel": 0, "plain": 1, "fallback": 0,
    }


def test_frontier_single_row():
    rp = np.array([0, 3, 7, 7, 12], np.int32)
    got = PF.deg_sum_plain(_t(rp), _t(np.array([1])), _t(np.array([True])))
    assert got.dtype == torch.int64 and int(got) == 4


def _raw(ptr, ctype, n):
    """``n`` values of ``ctype`` at a host address, as a kernel reads them."""
    if n == 0:
        return torch.from_numpy(np.zeros(0, np.dtype(ctype)))
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(ptr)).copy())


def _store(ptr, t):
    ctypes.memmove(ptr, t.contiguous().data_ptr(), t.numel() * t.element_size())


class _FrontierKernelEmulation:
    """``frontier_deg_sum.cu`` in torch, reading the wrapper's raw ctypes
    arguments as the kernel reads them (dense rows at the pointers)."""

    def frontier_deg_sum_scratch_bytes(self, device):
        return 16

    def frontier_deg_sum_launch(self, rp, nrp, pos, present, frontier, scratch, out, stream):
        r = _raw(rp, ctypes.c_int32, nrp).to(torch.int64)
        p = torch.clamp(_raw(pos, ctypes.c_int64, frontier), 0, max(nrp - 2, 0))
        m = _raw(present, ctypes.c_uint8, frontier) != 0
        deg = r[p + 1] - r[p] if nrp >= 2 else torch.zeros(frontier, dtype=torch.int64)
        _store(out, torch.sum(torch.where(m, deg, torch.zeros_like(deg))).reshape(1))
        return 0


def _strided_frontier(rng, rp, n, density):
    """A frontier whose pos and present are every other row of longer
    arrays: not contiguous."""
    n_nodes = len(rp) - 1
    pos = _t(rng.integers(0, n_nodes, 2 * n).astype(np.int64))[::2]
    present = _t(rng.random(2 * n) < density)[::2]
    assert not pos.is_contiguous() and not present.is_contiguous()
    return pos, present


@pytest.mark.parametrize("case", ["non_contiguous", "empty_mask"])
def test_frontier_plain_noncontiguous_and_empty_mask_match_reference(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    rp, _, _, pos, present = _csr_case("dense", 1000, 0.85)
    if case == "non_contiguous":
        pos_p, present_p = _strided_frontier(rng, rp, 700, 0.7)
    else:
        pos_p, present_p = _t(pos), _t(np.zeros_like(present))
    args_r = (jnp.asarray(rp), jnp.asarray(pos_p.numpy()), jnp.asarray(present_p.numpy()))
    want = RPF._csr_deg_sum_jnp(*args_r)
    _same(want, PF.deg_sum_plain(_t(rp), pos_p, present_p), (case, "plain"))
    _same(want, PF.csr_frontier_degree_sum(_t(rp), pos_p, present_p), (case, "gate"))
    if case == "empty_mask":
        assert int(want) == 0


@pytest.mark.parametrize(
    "shape_name,n,density", SHAPES + [("non_contiguous", 700, 0.7)]
)
def test_frontier_kernel_arguments_emulated_match_reference(
    monkeypatch, shape_name, n, density
):
    """The wrapper's ctypes arguments, read by a torch emulation of the
    kernel as the kernel reads them, give the reference's sum: pointers,
    lengths, and a dense copy of a strided input."""
    monkeypatch.setattr(PF, "_lib", lambda: _FrontierKernelEmulation())
    monkeypatch.setattr(PF._build, "stream", lambda dev: 0)
    monkeypatch.setattr(PF._build, "scratch_ptr", lambda kernel, dev, nbytes, stream: 0)
    rp, _, _, pos, present = _csr_case(shape_name, n, density)
    pos_p, present_p = _t(pos), _t(present)
    if shape_name == "non_contiguous":
        pos_p, present_p = _strided_frontier(np.random.default_rng(7), rp, n, density)
    want = RPF._csr_deg_sum_jnp(
        jnp.asarray(rp), jnp.asarray(pos_p.numpy()), jnp.asarray(present_p.numpy())
    )
    got = PF._launch(_t(rp), pos_p, present_p)
    assert got.shape == ()
    _same(want, got, shape_name)


# ---------------------------------------------------------------------------
# segment_agg
# ---------------------------------------------------------------------------

AGG_CASES = [
    ("count", "i64"), ("sum", "i64"), ("avg", "i64"), ("min", "i64"),
    ("max", "i64"), ("min", "f64"), ("max", "f64"), ("count", "f64"),
    ("min", "bool"), ("max", "bool"), ("min", "str"), ("max", "str"),
]


def _agg_data(rng, kind, n):
    if kind == "i64":
        return rng.integers(-(10**12), 10**12, n).astype(np.int64)
    if kind == "f64":
        v = rng.normal(0, 10, n)
        v[rng.random(n) < 0.15] = np.nan
        v[rng.random(n) < 0.1] = 0.0
        v[rng.random(n) < 0.1] = -0.0
        return v
    if kind == "bool":
        return rng.random(n) < 0.5
    return rng.integers(0, 40, n).astype(np.int32)  # dictionary codes


@pytest.mark.parametrize("name,kind", AGG_CASES)
@pytest.mark.parametrize("shape_name,n,density", SHAPES)
def test_segment_plain_matches_reference(
    interpret_mode, name, kind, shape_name, n, density
):
    rng = np.random.default_rng(zlib.crc32(f"{name}/{kind}/{shape_name}".encode()))
    k = max(min(n // 4, PA.MAX_GROUPS), 1)
    data = _agg_data(rng, kind, n)
    valid = rng.random(n) < density
    seg = rng.integers(0, k, n).astype(np.int64)
    # the no-mask variant compiles its own reference programs: one shape
    for vmask in (valid, None) if shape_name == "dense" else (valid,):
        args_r = (jnp.asarray(data), None if vmask is None else jnp.asarray(vmask),
                  None, jnp.asarray(seg))
        args_p = (_t(data), None if vmask is None else _t(vmask), None, _t(seg))
        want = RJ.segment_aggregate(*args_r, name=name, kind=kind, k=k)
        got = PJ.segment_aggregate(*args_p, name=name, kind=kind, k=k)
        got_gate = PA.segment_aggregate(*args_p, name=name, kind=kind, k=k)
        want_pallas = (
            RPA.segment_aggregate(*args_r, name=name, kind=kind, k=k)
            if name != "avg" else want
        )
        for i, (w, wp, g, gg) in enumerate(zip(want, want_pallas, got, got_gate)):
            if w is None:
                assert g is None and gg is None, i
                continue
            _same(w, g, (name, kind, shape_name, i, "jnp"))
            _same(wp, g, (name, kind, shape_name, i, "pallas-interpret"))
            _same(w, gg, (name, kind, shape_name, i, "gate"))


def test_segment_signed_zero_tie_matches_reference():
    """min prefers -0.0 and max prefers 0.0, in either row order — the
    JAX reference's rule, which the CUDA kernel states too."""
    for order in ([0.0, -0.0], [-0.0, 0.0]):
        data = np.array(order * 3)
        seg = np.zeros(6, np.int64)
        for name in ("min", "max"):
            want = RJ.segment_aggregate(
                jnp.asarray(data), None, None, jnp.asarray(seg),
                name=name, kind="f64", k=1,
            )[0]
            got = PJ.segment_aggregate(_t(data), None, None, _t(seg), name, "f64", 1)[0]
            _same(want, got, (order, name))
            assert bool(torch.signbit(got)[0]) == (name == "min")


def test_f64_order_keys_roundtrip_and_order():
    x = np.array([-np.inf, -1e300, -1.5, -0.0, 0.0, 5e-324, 2.0, np.inf])
    keys = PJ.f64_order_keys(_t(x))
    assert (keys[1:] > keys[:-1]).all()
    _same(x, PJ.f64_from_order_keys(keys), "roundtrip")


# count, sum and min/max over every kind the kernel reduces
GLOBAL_CASES = [("count", kind) for kind in ("i64", "bool", "str", "f64")] + [
    ("sum", "i64")
] + [(name, kind) for name in ("min", "max") for kind in ("i64", "bool", "str", "f64")]

# (name, rows, mask density or None for no mask)
GLOBAL_SHAPES = [
    ("empty", 0, None),
    ("all_masked", 40, 0.0),
    ("mixed", 200, 0.8),
    ("no_mask", 200, None),
]


def _special_data(rng, kind, n):
    """Values with the edge cases of each kind: int64 extremes; NaN, +-0.0
    and +-inf; both bools; string codes."""
    data = _agg_data(rng, kind, n)
    if n >= 8 and kind == "i64":
        data[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0, -1]
    if n >= 8 and kind == "f64":
        data[:6] = [np.inf, -np.inf, -0.0, 0.0, np.nan, -np.nan]
    return data


@pytest.mark.parametrize("name,kind", GLOBAL_CASES)
@pytest.mark.parametrize("shape_name,n,density", GLOBAL_SHAPES)
def test_segment_global_form_matches_reference(
    interpret_mode, name, kind, shape_name, n, density
):
    """A global aggregate passes no segment ids (None, k = 1): the plain
    version and the gate equal the reference's jnp and Pallas (interpret)
    formulations fed with ``jnp.zeros(n)`` ids, bit for bit."""
    rng = np.random.default_rng(zlib.crc32(f"global/{name}/{kind}/{shape_name}".encode()))
    data = _special_data(rng, kind, n)
    valid = None if density is None else rng.random(n) < density
    args_r = (jnp.asarray(data), None if valid is None else jnp.asarray(valid),
              None, jnp.zeros(n, jnp.int64))
    args_p = (_t(data), None if valid is None else _t(valid), None, None)
    want = RJ.segment_aggregate(*args_r, name=name, kind=kind, k=1)
    want_pallas = RPA.segment_aggregate(*args_r, name=name, kind=kind, k=1)
    got = PJ.segment_aggregate(*args_p, name=name, kind=kind, k=1)
    got_gate = PA.segment_aggregate(*args_p, name=name, kind=kind, k=1)
    for i, (w, wp, g, gg) in enumerate(zip(want, want_pallas, got, got_gate)):
        if w is None:
            assert g is None and gg is None, i
            continue
        _same(w, g, (name, kind, shape_name, i, "jnp"))
        _same(wp, g, (name, kind, shape_name, i, "pallas-interpret"))
        _same(w, gg, (name, kind, shape_name, i, "gate"))
    assert PD.use_counts()["segment_agg"]["plain"] == 1


class _SegmentKernelEmulation:
    """The row rule and the finalize of ``segment_reduce.cu`` in torch,
    reading the wrapper's raw ctypes arguments as the kernel reads them:
    values by the value-type code, validity bytes, segment ids by the
    segment-type code (a row outside [0, k) takes no part), a null or NaN
    row takes ``fill``, an untouched group keeps ``ident``, float64 min/max
    on order keys, then the NaN rules and each output in its own type."""

    CTYPES = {1: ctypes.c_int32, 2: ctypes.c_int64, 3: ctypes.c_double, 4: ctypes.c_uint8}

    def segment_reduce_scratch_bytes(self, device):
        return 16

    def segment_reduce_launch(self, vals, vtype, valid, seg, stype, n, k, op, ident,
                              fill, out, out_valid, scratch, stream):
        assert (seg is None) == (stype == 0) and (vals is None) == (vtype == 0)
        i64 = torch.int64
        g = _raw(seg, self.CTYPES[stype], n).to(i64) if seg else torch.zeros(n, dtype=i64)
        rows = (g >= 0) & (g < k)
        live = rows & (_raw(valid, ctypes.c_uint8, n) != 0) if valid else rows
        nan = torch.zeros(n, dtype=torch.bool)
        if vtype == 0:
            x = torch.zeros(n, dtype=i64)
        elif vtype == 3:
            d = _raw(vals, ctypes.c_double, n)
            nan = live & torch.isnan(d)
            x = PJ.f64_order_keys(d)
        elif vtype == 4:
            x = (_raw(vals, ctypes.c_uint8, n) != 0).to(i64)
        else:
            x = _raw(vals, self.CTYPES[vtype], n).to(i64)
        x = torch.where(live & ~nan, x, torch.full_like(x, fill))
        gr = g[rows]
        cnt = torch.zeros(k, dtype=i64).index_add_(0, gr, live[rows].to(i64))
        nan_cnt = torch.zeros(k, dtype=i64).index_add_(0, gr, nan[rows].to(i64))
        acc = torch.full((k,), ident, dtype=i64)
        if op == 1:
            acc = acc.index_add_(0, gr, x[rows])
        elif op in (2, 3):
            acc = acc.scatter_reduce(0, gr, x[rows], "amin" if op == 2 else "amax",
                                     include_self=True)
        if op == 0:
            _store(out, cnt)
            return 0
        if op == 1:
            _store(out, acc)
            return 0
        _store(out_valid, cnt > 0)
        if vtype == 1:
            acc = acc.to(torch.int32)
        elif vtype == 4:
            acc = acc != 0
        elif vtype == 3:
            nan_out = (nan_cnt > 0) & (cnt == nan_cnt) if op == 2 else nan_cnt > 0
            bits = torch.where(acc < 0, acc ^ 0x7FFFFFFFFFFFFFFF, acc)
            acc = torch.where(nan_out, torch.full_like(acc, 0x7FF8000000000000), bits)
        _store(out, acc)
        return 0


@pytest.mark.parametrize("name,kind", GLOBAL_CASES)
@pytest.mark.parametrize("seg_form", ["none", "int32_k1", "int32_k7", "int64_k256"])
def test_segment_kernel_arguments_emulated_match_plain(monkeypatch, name, kind, seg_form):
    """The wrapper's ctypes arguments (op and value-type codes, identity and
    fill bits, segment-type code, null pointers), read by a torch emulation
    of the fused kernel's row rule and finalize, give the plain version's
    4-tuple bit for bit. The kernel itself runs only on the card
    (``chip_smoke.py`` holds it to the plain version there)."""
    monkeypatch.setattr(PA, "_lib", lambda: _SegmentKernelEmulation())
    monkeypatch.setattr(PA._build, "stream", lambda dev: 0)
    monkeypatch.setattr(PA._build, "scratch_ptr", lambda kernel, dev, nbytes, stream: 0)
    rng = np.random.default_rng(zlib.crc32(f"emul/{name}/{kind}/{seg_form}".encode()))
    k = {"none": 1, "int32_k1": 1, "int32_k7": 7, "int64_k256": 256}[seg_form]
    for n, density in ((0, None), (300, 0.8), (300, None), (60, 0.0)):
        data = _special_data(rng, kind, n)
        valid = None if density is None else rng.random(n) < density
        seg = rng.integers(0, min(k, 6), n)  # group 6 of k = 7 stays empty
        if k == 7 and valid is not None:
            valid[seg == 5] = False  # a group whose rows are all null
        seg_t = {"none": None, "int64_k256": _t(seg.astype(np.int64))}.get(
            seg_form, _t(seg.astype(np.int32))
        )
        args = (_t(data), None if valid is None else _t(valid))
        got = PA._launch(*args, seg_t, name, kind, k)
        want = PJ.segment_aggregate(*args, None, seg_t, name, kind, k)
        for i, (w, g) in enumerate(zip(want, got)):
            if w is None:
                assert g is None, i
                continue
            _same(w, g, (name, kind, seg_form, n, density, i))


@pytest.mark.parametrize("name", ["min", "max"])
@pytest.mark.parametrize("kind", ["date", "ldt", "zdt", "zt", "lt"])
def test_segment_gate_takes_temporal_minmax_on_kernel_tier(monkeypatch, name, kind):
    """min and max over a one-lane temporal payload (a date's int32 days,
    the other kinds' int64 micros, before and after 1970) are eligible: on
    a CUDA tensor the gate takes the kernel tier, and the kernel's ctypes
    arguments, read by the emulation, give the plain version's 4-tuple bit
    for bit, nulls and an empty group included."""
    monkeypatch.setattr(PA, "_lib", lambda: _SegmentKernelEmulation())
    monkeypatch.setattr(PA._build, "stream", lambda dev: 0)
    monkeypatch.setattr(PA._build, "scratch_ptr", lambda kernel, dev, nbytes, stream: 0)
    monkeypatch.setattr(PA, "_segment_aggregate_cuda", PA._launch)
    monkeypatch.setattr(PA.dispatch, "launch", _as_cuda(PD.launch))
    rng = np.random.default_rng(zlib.crc32(f"temporal/{name}/{kind}".encode()))
    n = 300
    if kind == "date":  # days in years 1..9999
        data = rng.integers(-719_162, 2_932_897, n).astype(np.int32)
    else:  # micros within a day, or across years 1..9999
        hi = 86_400 * 10**6 if kind in ("zt", "lt") else 253_402_300_799 * 10**6
        data = rng.integers(-hi if kind != "lt" else 0, hi, n).astype(np.int64)
    valid = rng.random(n) < 0.8
    for seg in (None, rng.integers(0, 6, n).astype(np.int64)):  # group 6 of 7 is empty
        k = 1 if seg is None else 7
        args = (_t(data), _t(valid), None, None if seg is None else _t(seg))
        want = PJ.segment_aggregate(*args, name, kind, k)
        got = PA.segment_aggregate(*args, name=name, kind=kind, k=k)
        for i, (w, g) in enumerate(zip(want, got)):
            if w is None:
                assert g is None, i
                continue
            _same(w, g, (name, kind, k, i))
    assert PD.use_counts()["segment_agg"] == {"kernel": 2, "plain": 0, "fallback": 0}


def test_segment_kernel_plan_mirrors_plain_fills():
    """Spot values of the identities and fills the wrapper hands the kernel."""
    i64 = np.iinfo(np.int64)
    assert PA.kernel_plan("max", "i64", torch.int64)[3:] == (i64.min, -i64.max)
    assert PA.kernel_plan("min", "i64", torch.int64)[3:] == (i64.max, i64.max)
    assert PA.kernel_plan("max", "str", torch.int32)[3:] == (np.iinfo(np.int32).min, -1)
    assert PA.kernel_plan("max", "bool", torch.bool)[3:] == (-128, -127)
    inf_key = int(PJ.f64_order_keys(torch.tensor([np.inf], dtype=torch.float64))[0])
    assert PA.kernel_plan("min", "f64", torch.float64)[3:] == (inf_key, inf_key)
    assert PA.kernel_plan("count", "f64", torch.float64) == (0, 0, torch.int64, 0, 0)
    with pytest.raises(TypeError):
        PA.kernel_plan("sum", "f64", torch.float64)


# ---------------------------------------------------------------------------
# intersect
# ---------------------------------------------------------------------------


def _range_case(name):
    """(keys, q, qvalid) for one shape class of the range-count contract."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "empty_q":
        keys = np.sort(rng.integers(0, 100, 40)).astype(np.int64)
        return keys, np.zeros(0, np.int64), np.zeros(0, bool)
    if name == "all_invalid":
        keys = np.sort(rng.integers(0, 100, 64)).astype(np.int64)
        q = rng.integers(-5, 110, 200).astype(np.int64)
        return keys, q, np.zeros(200, bool)
    if name == "single_key":
        return np.array([17], np.int64), np.array([-1, 16, 17, 18, 1 << 40], np.int64), \
            np.array([True, True, True, False, True])
    if name == "pow2_past_max":
        # the case the TPU kernel's completion half-step exists for: a
        # sentinel-free power-of-two key list, queries at and past the max
        keys = np.sort(rng.integers(0, 500, 256)).astype(np.int64)
        top = int(keys[-1])
        q = np.concatenate([
            np.array([top, top, top + 1, top + 10**9, 1 << 61], np.int64),
            rng.integers(-3, top + 3, 300).astype(np.int64),
        ])
        return keys, q, rng.random(q.shape[0]) < 0.9
    if name == "duplicate_runs":
        keys = np.sort(np.repeat(rng.integers(0, 30, 40), rng.integers(1, 9, 40)))
        q = rng.integers(-2, 33, 700).astype(np.int64)
        return keys.astype(np.int64), q, rng.random(700) < 0.7
    if name == "sentinel_padded":
        real = np.sort(rng.integers(0, 50, 37)).astype(np.int64)
        keys = np.concatenate([real, np.full(27, 1 << 62, np.int64)])
        q = np.arange(-2, 55, dtype=np.int64)
        return keys, q, np.ones(q.shape[0], bool)
    # larger: edge-key-shaped (anchor*N + candidate) over a random graph
    n = 2000
    src, dst = rng.integers(0, n, 30000), rng.integers(0, n, 30000)
    keys = np.sort(src.astype(np.int64) * n + dst)
    q = rng.integers(0, n, 5000).astype(np.int64) * n + rng.integers(0, n, 5000)
    q[:2000] = keys[rng.integers(0, keys.shape[0], 2000)]
    return keys, q, rng.random(5000) < 0.8


RANGE_SHAPES = [
    "empty_q", "all_invalid", "single_key", "pow2_past_max",
    "duplicate_runs", "sentinel_padded", "larger",
]


@pytest.mark.parametrize("shape_name", RANGE_SHAPES)
def test_intersect_plain_matches_reference(interpret_mode, shape_name):
    keys, q, qvalid = _range_case(shape_name)
    args_r = (jnp.asarray(keys), jnp.asarray(q), jnp.asarray(qvalid))
    args_p = (_t(keys), _t(q), _t(qvalid))
    want = RPI._range_count_jnp(*args_r)
    got = PI.range_count_plain(*args_p)
    got_gate = PI.intersect_range_count(*args_p)
    want_pallas = (
        RPI._range_count_pallas(
            *args_r, npow=RB.round_up_pow2(len(keys)), interpret=True
        )
        if len(q) else want
    )
    for nm, w, wp, g, gg in zip(("lo", "counts", "total"), want, want_pallas, got, got_gate):
        _same(w, g, (shape_name, nm, "jnp"))
        _same(wp, g, (shape_name, nm, "pallas-interpret"))
        _same(w, gg, (shape_name, nm, "gate"))
    assert PD.use_counts()["intersect"] == {"kernel": 0, "plain": 1, "fallback": 0}


def test_intersect_launch_error_raises_typed_and_is_not_memoized(monkeypatch):
    """A nonzero cudaError from the launch raises typed at the
    ``kernel_intersect`` site, every time: no broken-once memo, no answer
    from the plain version."""
    from tpu_cypher_torch.backend.cuda.hopper import _build

    calls = []

    def refused(*a):
        calls.append(1)
        _build.check(719, "intersect")

    monkeypatch.setattr(PI, "_range_count_kernel_tier", refused)
    monkeypatch.setattr(PI.dispatch, "launch", _as_cuda(PD.launch))
    keys, q, qvalid = _range_case("larger")
    for _ in range(2):
        with pytest.raises(PERR.DeviceError, match="cudaError 719") as info:
            PI.intersect_range_count(_t(keys), _t(q), _t(qvalid))
        assert info.value.site == "kernel_intersect"
    assert len(calls) == 2
    assert PD.use_counts()["intersect"] == {"kernel": 0, "plain": 0, "fallback": 0}


@pytest.mark.parametrize("case", ["no_keys", "empty_q"])
def test_intersect_ineligible_cuda_call_takes_fallback_tier(monkeypatch, case):
    """An empty key list or an empty query list is no call for the kernel:
    on a CUDA tensor it runs the plain version on the ``fallback`` tier."""
    monkeypatch.setattr(PI, "_range_count_kernel_tier", lambda *a: pytest.fail("kernel ran"))
    monkeypatch.setattr(PI.dispatch, "launch", _as_cuda(PD.launch))
    keys, q, qvalid = _range_case("empty_q" if case == "empty_q" else "all_invalid")
    if case == "no_keys":
        keys = keys[:0]
    lo, counts, total = PI.intersect_range_count(_t(keys), _t(q), _t(qvalid))
    assert lo.shape == counts.shape == (len(q),) and int(total) == 0
    assert PD.use_counts()["intersect"] == {"kernel": 0, "plain": 0, "fallback": 1}


def _lower_bound_emulated(k, b, n, x, probes):
    """``range_count.cu``'s branchless lower bound of each ``x`` in
    ``k[b, b + n)``, vectorised; every probed index goes to ``probes``."""
    b, n = b.copy(), n.copy()
    while (n > 1).any():
        m = n > 1
        half = n >> 1
        idx = np.where(m, b + half, 0)
        probes.append((idx[m], b[m], (b + n)[m]))
        b = np.where(m & (k[idx] < x), b + half, b)
        n = np.where(m, n - half, n)
    m = n >= 1
    idx = np.where(m, b, 0)
    probes.append((idx[m], b[m], (b + n)[m]))
    return b + (m & (k[idx] < x))


class _RangeCountKernelEmulation:
    """``range_count.cu`` in torch and numpy, reading the wrapper's raw
    ctypes arguments as its index and search kernels read them. The
    bucket starts: the unsigned span and shift, then per key the buckets
    from its predecessor's (runs of at most 32) into the start table,
    the rest left -1. The records: per bucket its start and the next
    bucket's, each read from the table or, where unset, the lower bound
    of the bucket's first value (``nk`` past kmax); then, for at most 6
    keys and a shift of at most 14, their offsets in the bucket as 16-bit
    lanes 0x8000 | offset (other lanes 0xFFFF), else the search flag
    (bit 31 of the start) and the bucket's end in the second word. The
    search: a query below kmin or above kmax takes 0 or nk; any other
    reads its bucket's record and counts the inline offsets below and
    equal to its own, or searches only the bucket's range [s, e), a hit
    galloping from lo to the end of its run and never past e. Every
    probed key index is checked to lie inside the range it searches."""

    def __init__(self):
        self.tables = []  # (shift, start, records) of each launch
        self.inline_lanes = 0  # query lanes answered from a record's offsets
        self.searched_lanes = 0  # query lanes that searched their bucket's keys
        self.resolved_in_pass2 = 0  # starts the per-key pass left unset

    @staticmethod
    def _shift(k, log2b):
        span = (int(k[-1]) - int(k[0])) % 2**64
        return span, max(0, span.bit_length() - log2b)

    def _bucket_starts(self, k, log2b, start):
        """Pass 1 into the ``start`` buffer; the resolved starts (pass 2's
        reads of it) returned, start[B] included."""
        nk = len(k)
        span, shift = self._shift(k, log2b)
        nb = 1 << log2b
        # pass 1, per key i: start[b] = i for b in (bucket(k[i - 1]), bucket(k[i])],
        # runs of at most 32 buckets; the rest stays -1
        bk = ((k.view(np.uint64) - k[:1].view(np.uint64)) >> np.uint64(shift)).astype(np.int64)
        prev = np.concatenate([[-1], bk[:-1]])
        run = np.where(bk - prev <= 32, bk - prev, 0)
        out = np.full(nb + 1, -1, np.int64)
        first_b = np.repeat(prev + 1, run)
        out[first_b + np.arange(run.sum()) - np.repeat(np.cumsum(run) - run, run)] = \
            np.repeat(np.arange(nk), run)
        out[nb] = nk
        _store(start, torch.from_numpy(out.astype(np.int32)))
        # pass 2's reads, per bucket: an unset start is the lower bound of
        # the bucket's first value, nk past kmax
        st = _raw(start, ctypes.c_int32, nb + 1).numpy().astype(np.int64)
        unset = np.flatnonzero(st[:nb] < 0)
        off = unset.astype(np.uint64) << np.uint64(shift)
        first = (k[:1].view(np.uint64) + off).view(np.int64)
        probes = []
        lb = _lower_bound_emulated(k, np.zeros(len(unset), np.int64),
                                   np.full(len(unset), nk, np.int64), first, probes)
        st[unset] = np.where(off <= np.uint64(span), lb, nk)
        self.resolved_in_pass2 = len(unset)
        return shift, st

    @staticmethod
    def _offsets(k, x, shift):
        return ((x.view(np.uint64) - k[:1].view(np.uint64))
                & np.uint64((1 << shift) - 1)).astype(np.int64)

    def _records(self, k, shift, st, records):
        s, e = st[:-1], st[1:]
        n = e - s
        small = (n <= 6) if shift <= 14 else np.zeros(len(s), bool)
        j = np.arange(6)
        take = small[:, None] & (j[None, :] < n[:, None])
        pos = np.where(take, s[:, None] + j[None, :], 0)
        lanes = np.where(take, 0x8000 | self._offsets(k, k[pos], shift), 0xFFFF)
        words = lanes[:, 0::2] | (lanes[:, 1::2] << 16)
        words[:, 0] = np.where(small, words[:, 0], e)
        out = np.concatenate([(s | np.where(small, 0, 1 << 31))[:, None], words], axis=1)
        out = out.astype(np.uint32).view(np.int32)
        _store(records, torch.from_numpy(out))
        self.tables.append((shift, st.astype(np.int32), out))

    def range_count_launch(self, keys, nk, log2b, start, records, q, qvalid, lo_out,
                           cnt_out, nq, stream):
        assert 0 < nk <= 2**31 - 1 and 1 <= log2b <= 30 and nq > 0
        k = _raw(keys, ctypes.c_int64, nk).numpy()
        shift, st = self._bucket_starts(k, log2b, start)
        self._records(k, shift, st, records)
        rec = _raw(records, ctypes.c_int32, 4 << log2b).numpy().view(np.uint32)
        rec = rec.astype(np.int64).reshape(-1, 4)
        x = _raw(q, ctypes.c_int64, nq).numpy()
        valid = _raw(qvalid, ctypes.c_uint8, nq).numpy() != 0
        inside = (x >= k[0]) & (x <= k[-1])
        xi = x[inside]
        bk = ((xi.view(np.uint64) - k[:1].view(np.uint64)) >> np.uint64(shift)).astype(np.int64)
        s = rec[bk, 0] & ~(1 << 31)
        # records whose offsets are inline: count the lanes below and equal
        fast = (rec[bk, 0] >> 31) == 0
        e = np.where(fast, s, rec[bk, 1])  # the others read the bucket's end
        # the kernel's word arithmetic: per word (w - x * 0x10001) >> 15
        # keeps a 1 in each 16-bit lane whose offset is >= x
        xo = self._offsets(k, xi, shift)[:, None]

        def at_least(x):
            d = (rec[bk, 1:] - x * 0x10001) % 2**32
            ge = ((d >> 15) & 0x00010001).sum(axis=1)
            return (ge & 0xFFFF) + (ge >> 16)

        n_ge = at_least(xo)
        fast_lo = s + 6 - n_ge
        fast_cnt = n_ge - at_least(xo + 1)
        # the others: the branchless search of the bucket's keys
        probes = []
        lo_in = _lower_bound_emulated(k, s, e - s, xi, probes)
        for idx, lo_b, hi_b in probes:
            assert ((idx >= lo_b) & (idx < hi_b)).all(), "a search left its bucket"
        hit = ~fast & valid[inside] & (lo_in < e) & (k[np.minimum(lo_in, nk - 1)] == xi)
        # the gallop: steps 1, 2, 4, ... while the key still equals x, then halving
        last, step, run = lo_in.copy(), np.ones_like(lo_in), hit.copy()
        while run.any():
            nxt = last + step
            run &= nxt < e
            run[run] = k[nxt[run]] == xi[run]
            last, step = np.where(run, nxt, last), np.where(run, step * 2, step)
        hi = np.minimum(last + step, e)
        while (hit & (hi - last > 1)).any():
            m = hit & (hi - last > 1)
            mid = last + ((hi - last) >> 1)
            assert (mid[m] < e[m]).all(), "a gallop left its bucket"
            eq = m & (k[np.where(m, mid, 0)] == xi)
            last, hi = np.where(eq, mid, last), np.where(m & ~eq, mid, hi)
        lo = np.where(x < k[0], 0, nk).astype(np.int64)
        cnt = np.zeros(nq, np.int64)
        lo[inside] = np.where(fast, fast_lo, lo_in)
        cnt[inside] = np.where(fast, np.where(valid[inside], fast_cnt, 0),
                               np.where(hit, hi - lo_in, 0))
        self.inline_lanes += int(fast.sum())
        self.searched_lanes += int((~fast).sum())
        _store(lo_out, torch.from_numpy(lo))
        _store(cnt_out, torch.from_numpy(cnt))
        return 0


_I64 = np.iinfo(np.int64)


def _index_case(name):
    """(keys, q, qvalid) for the index's edge shapes."""
    rng = np.random.default_rng(zlib.crc32(f"index/{name}".encode()))
    if name in ("closing_probe", "q6_neighbours"):
        # a CSR's src*N + dst keys, parallel edges kept
        # (the closing probe's sources uniform, Q6's zipf-skewed)
        n = 1500
        src = rng.integers(0, n, 20000) if name == "closing_probe" else rng.zipf(1.6, 20000) % n
        dst = rng.integers(0, n, 20000)
        order = np.lexsort((dst, src))
        src, dst = src[order].astype(np.int64), dst[order].astype(np.int64)
        keys = src * n + dst
        rp = np.searchsorted(src, np.arange(n + 1))
        # the 2-paths a -> b -> c, in a's order (the final hop's lanes)
        deg = rp[dst + 1] - rp[dst]
        a = np.repeat(src, deg)
        c = dst[np.concatenate([np.arange(rp[b], rp[b + 1]) for b in dst])]
        # closing probe: c*N + a (neighbouring lanes N apart); Q6: a*N + c
        # along b's row (neighbouring lanes on neighbouring keys)
        q = c * n + a if name == "closing_probe" else a * n + c
        return keys, q, rng.random(q.shape[0]) < 0.9
    if name == "hub":
        keys = np.sort(np.concatenate([
            np.full(3000, 7 * 2**20, np.int64) + rng.integers(0, 4000, 3000),
            rng.integers(0, 2**40, 200),
        ]))
        q = np.concatenate([keys[rng.integers(0, keys.shape[0], 2000)],
                            rng.integers(-5, 2**40 + 5, 2000)])
        return keys, q, rng.random(q.shape[0]) < 0.8
    if name == "all_equal":
        keys = np.full(777, 42, np.int64)
        q = np.array([_I64.min, 0, 41, 42, 42, 43, _I64.max], np.int64)
        return keys, q, np.array([True, True, True, True, False, True, True])
    if name == "one_key":
        return np.array([-9], np.int64), np.array([_I64.min, -10, -9, -9, -8, _I64.max]), \
            np.array([True, True, True, False, True, True])
    if name == "outside":
        keys = np.sort(rng.integers(10**6, 2 * 10**6, 5000)).astype(np.int64)
        q = np.concatenate([np.array([_I64.min, _I64.max, 10**6 - 1, 2 * 10**6], np.int64),
                            rng.integers(-(10**7), 10**6, 500),
                            rng.integers(2 * 10**6, 10**7, 500)])
        return keys, q, rng.random(q.shape[0]) < 0.9
    if name == "negative_wide":
        # negative keys and a span of 2**64 - 1: the unsigned span and shift
        body = np.sort(rng.integers(_I64.min, _I64.max, 3000, dtype=np.int64))
        keys = np.concatenate([[_I64.min, _I64.min], body, [_I64.max - 1, _I64.max]])
        q = np.concatenate([keys[rng.integers(0, keys.shape[0], 1500)],
                            rng.integers(_I64.min, _I64.max, 1500, dtype=np.int64),
                            np.array([_I64.min, _I64.max, -1, 0, 1], np.int64)])
        return keys, q, rng.random(q.shape[0]) < 0.9
    if name == "bucket_edge_runs":
        # runs of duplicates on and just below bucket starts (multiples of
        # 2**12 over a span of 2**20: an edge at every shift up to 12)
        edges = np.arange(1, 256, dtype=np.int64) << 12
        vals = np.concatenate([[0, 2**20 - 1], edges, edges - 1, edges + 1])
        keys = np.sort(np.repeat(vals, rng.integers(1, 12, vals.shape[0])))
        q = np.concatenate([vals, vals + 2, rng.integers(-3, 2**20 + 3, 3000)])
        return keys, q, rng.random(q.shape[0]) < 0.85
    if name == "far_key":
        # a cluster and one far key: the empty buckets between them are
        # too many for the key's thread, so each is searched on its own
        keys = np.sort(np.concatenate([rng.integers(0, 5000, 3000), [2**50, 2**50]]))
        q = np.concatenate([keys, rng.integers(-5, 2**50 + 5, 2000), [2**49, 2**50 - 1]])
        return keys.astype(np.int64), q.astype(np.int64), rng.random(q.shape[0]) < 0.9
    if name == "max_offsets":
        # a span of 2**18 in 16 buckets: shift 14, the widest with inline
        # offsets, keys and queries at a bucket's last offset 2**14 - 1
        top = np.arange(16, dtype=np.int64) * 2**14 + 2**14 - 1
        keys = np.sort(np.concatenate([[0], top, top[::3], rng.integers(0, 2**18, 15)]))
        q = np.concatenate([top, top - 1, top + 1, keys, [2**18, -1]])
        return keys, q, rng.random(q.shape[0]) < 0.9
    # invalid lanes: the larger range shape with most lanes invalid
    keys, q, _ = _range_case("larger")
    return keys, q, rng.random(q.shape[0]) < 0.1


INDEX_SHAPES = [
    "closing_probe", "q6_neighbours", "hub", "all_equal", "one_key", "outside",
    "negative_wide", "bucket_edge_runs", "far_key", "max_offsets", "invalid_lanes",
]


def _index_want(keys, bits):
    """``start`` and the records by their definitions, in Python
    integers."""
    kmin, kmax = int(keys[0]), int(keys[-1])
    shift = max(0, (kmax - kmin).bit_length() - bits)
    firsts = [kmin + (b << shift) for b in range(1 << bits)]
    pos = [int(np.searchsorted(keys, f, side="left")) if f <= kmax else len(keys)
           for f in firsts]
    start = pos + [len(keys)]
    records = []
    for b in range(1 << bits):
        s, n = start[b], start[b + 1] - start[b]
        lanes = [0xFFFF] * 6
        inline = n <= 6 and shift <= 14
        if inline:
            lanes[:n] = [0x8000 | (int(v) - kmin) % (1 << shift) for v in keys[s:s + n]]
        words = [lanes[i] | lanes[i + 1] << 16 for i in range(0, 6, 2)]
        if not inline:
            words[0] = start[b + 1]
        records.append([s | (0 if inline else 1 << 31)] + words)
    return np.array(start, np.int32), np.array(records, np.uint32).view(np.int32)


def _emulated_range_count(monkeypatch):
    emu = _RangeCountKernelEmulation()
    monkeypatch.setattr(PI, "_lib", lambda: emu)
    monkeypatch.setattr(PI._build, "stream", lambda dev: 0)
    return emu


def _check_emulated(emu, keys, q, qvalid, bits, what):
    args = (_t(keys), _t(q), _t(qvalid))
    want = PI.range_count_plain(*args)
    lo, counts = PI._launch(*args, bits)
    for nm, w, g in zip(("lo", "counts", "total"), want, (lo, counts, torch.sum(counts))):
        _same(w.numpy(), g, (what, bits, nm))
    nbits = PI.bucket_bits(len(keys)) if bits is None else bits
    shift, table, records = emu.tables[-1]
    want_table, want_records = _index_want(keys, nbits)
    assert np.array_equal(table, want_table), (what, bits, "index")
    assert np.array_equal(records, want_records), (what, bits, "records")
    _same(want_table, PI.bucket_start_plain(_t(keys), nbits), (what, bits, "plain index"))
    return shift, table


@pytest.mark.parametrize("bits", [None, 1, 4])
@pytest.mark.parametrize("shape_name", RANGE_SHAPES[1:] + INDEX_SHAPES)
def test_intersect_kernel_arguments_emulated_match_plain(monkeypatch, shape_name, bits):
    """The wrapper's ctypes arguments, read by a torch emulation of the
    index and search kernels, give ``range_count_plain``'s
    (lo, counts, total) bit for bit, and the start table and the records
    equal their definitions (``searchsorted(keys, kmin + (b << shift))``,
    nk past kmax; start, and inline offsets or the end) and the start table
    ``bucket_start_plain``, at the real bucket count and at 2 and 16
    buckets. The kernels themselves run only on the card
    (``chip_smoke.py`` holds them to the plain version there)."""
    emu = _emulated_range_count(monkeypatch)
    keys, q, qvalid = (_index_case if shape_name in INDEX_SHAPES else _range_case)(shape_name)
    shift, table = _check_emulated(emu, keys, q, qvalid, bits, shape_name)
    if bits is None and shape_name == "closing_probe":
        # at the real B nearly every closing-probe query is answered from
        # its bucket's record alone
        assert len(table) - 1 == 1 << PI.bucket_bits(len(keys)) >= len(keys) // 8
        assert emu.inline_lanes > 0.8 * len(q) and emu.searched_lanes > 0
    if shape_name == "hub":
        assert emu.searched_lanes > 0
    if shape_name == "far_key" and bits is None:
        assert emu.resolved_in_pass2 > 32
    if shape_name == "max_offsets" and bits is None:
        assert shift == 14 and emu.inline_lanes == int(((q >= keys[0]) & (q <= keys[-1])).sum())
    if shape_name == "all_equal":
        assert (table[1:] == len(keys)).all() and table[0] == 0
    if shape_name == "negative_wide":
        assert shift == 64 - (PI.bucket_bits(len(keys)) if bits is None else bits)


def test_intersect_emulated_empty_query_list_makes_no_launch(monkeypatch):
    emu = _emulated_range_count(monkeypatch)
    keys, q, qvalid = _range_case("empty_q")
    lo, counts = PI._launch(_t(keys), _t(q), _t(qvalid))
    assert lo.shape == counts.shape == (0,) and not emu.tables


def test_intersect_emulated_random_sorted_keys_match_plain():
    """Random sorted key lists, duplicates and far keys mixed, queried at
    every key, its neighbours and random values, valid or not, at the
    real or a forced bucket count."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=60, deadline=None, derandomize=True, database=None)
    @hypothesis.given(
        keys=st.lists(st.one_of(st.integers(-40, 40), st.integers(_I64.min, _I64.max)),
                      min_size=1, max_size=120),
        extra=st.lists(st.integers(_I64.min, _I64.max), max_size=20),
        bits=st.one_of(st.none(), st.integers(1, 8)),
        data=st.data(),
    )
    def check(keys, extra, bits, data):
        with pytest.MonkeyPatch.context() as mp:
            emu = _emulated_range_count(mp)
            k = np.sort(np.array(keys, np.int64))
            near = np.concatenate([k, k[k > _I64.min] - 1, k[k < _I64.max] + 1])
            q = np.concatenate([near, np.array(extra, np.int64)])
            qvalid = np.array(data.draw(st.lists(st.booleans(), min_size=len(q),
                                                 max_size=len(q))), bool)
            _check_emulated(emu, k, q, qvalid, bits, "hypothesis")

    check()


# ---------------------------------------------------------------------------
# kernel scratch
# ---------------------------------------------------------------------------


def test_scratch_ptr_keys_buffers_by_stream(monkeypatch):
    """Two stream handles get two zeroed buffers; one handle gets its
    buffer again, without asking for a size."""
    monkeypatch.setattr(PB, "_SCRATCH", {})
    a = PB.scratch_ptr("k", CPU, lambda index: 32, 0x1111)
    b = PB.scratch_ptr("k", CPU, lambda index: 32, 0x2222)
    assert a != b
    assert PB.scratch_ptr("k", CPU, lambda index: pytest.fail("reallocated"), 0x1111) == a
    for ptr in (a, b):
        assert not _raw(ptr, ctypes.c_uint8, 32).any()
    assert PB.scratch_ptr("other", CPU, lambda index: 32, 0x1111) not in (a, b)


def test_scratch_ptr_racing_first_calls_get_one_buffer(monkeypatch):
    """Two threads racing on a first launch on one stream get one buffer,
    sized once."""
    monkeypatch.setattr(PB, "_SCRATCH", {})
    sized = []
    barrier = threading.Barrier(2)

    def nbytes(index):
        sized.append(index)
        time.sleep(0.05)  # widen the race window
        return 64

    got = []

    def first_launch():
        barrier.wait()
        got.append(PB.scratch_ptr("race", CPU, nbytes, 0x3333))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert len(got) == 2 and got[0] == got[1]
    assert len(sized) == 1


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def test_gate_cpu_tier_runs_plain_and_counts():
    out = PD.launch(
        "segment_agg", lambda: pytest.fail("kernel on CPU"), lambda: 7, device=CPU
    )
    assert out == 7
    assert PD.use_counts()["segment_agg"] == {"kernel": 0, "plain": 1, "fallback": 0}


def test_gate_cuda_tier_error_raises_and_is_not_memoized():
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("launch refused")

    cuda = torch.device("cuda", 0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="launch refused"):
            PD.launch("expand_rows", broken, lambda: pytest.fail("fell back"), device=cuda)
    assert len(calls) == 2  # never memoized: the second call tries again
    assert PD.use_counts()["expand_rows"] == {"kernel": 0, "plain": 0, "fallback": 0}


def test_gate_cuda_tier_launch_error_through_wrapper(monkeypatch):
    """The wrapper's launch function returns a nonzero cudaError: the
    dispatch raises it typed instead of answering from the plain version."""
    from tpu_cypher_torch.backend.cuda.hopper import _build

    monkeypatch.setattr(
        PE, "expand_materialize_counted_cuda",
        lambda *a: _build.check(719, "expand_rows"),
    )
    rp, ci, eo, pos, present = _csr_case("dense", 1000, 0.85)
    deg, tot = PJ.expand_degrees_total(_t(rp), _t(pos), _t(present))
    monkeypatch.setattr(PE.dispatch, "launch", _as_cuda(PD.launch))
    with pytest.raises(PERR.DeviceError, match="cudaError 719") as info:
        PE.expand_materialize_counted(
            _t(rp), _t(ci), _t(eo), _t(pos), deg, int(tot), size=int(tot)
        )
    assert info.value.site == "kernel_expand"


def _as_cuda(launch):
    def wrapped(name, kernel_fn, plain_fn, *, device, eligible=True):
        return launch(name, kernel_fn, plain_fn, device=torch.device("cuda", 0),
                      eligible=eligible)

    return wrapped


def test_gate_cuda_oom_surfaces_typed():
    class OutOfMemoryError(RuntimeError):  # torch.cuda.OutOfMemoryError's name
        pass

    def oom():
        raise OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    with pytest.raises(PERR.DeviceOOM):
        PD.launch("frontier_deg_sum", oom, lambda: 0, device=torch.device("cuda", 0))


def test_gate_cuda_ineligible_takes_fallback_tier():
    out = PD.launch(
        "segment_agg", lambda: pytest.fail("ineligible kernel ran"), lambda: 3,
        device=torch.device("cuda", 0), eligible=False,
    )
    assert out == 3
    assert PD.use_counts()["segment_agg"] == {"kernel": 0, "plain": 0, "fallback": 1}


def test_gate_registry_names_the_tpu_kernels():
    reg = PD.registry()
    assert set(reg) == {
        "expand_rows", "frontier_deg_sum", "segment_agg", "intersect", "join_probe",
    }
    for spec in reg.values():
        path, line = spec.replaces.rsplit(":", 1)
        assert path.startswith("tpu_cypher/backend/tpu/pallas/") and line.isdigit()
        assert spec.source.startswith("tpu_cypher_torch/csrc/")


def test_segment_ineligible_float_sum_is_plain_on_cpu():
    data = _t(np.array([1.5, 2.5]))
    seg = _t(np.zeros(2, np.int64))
    out = PA.segment_aggregate(data, None, None, seg, name="sum", kind="f64", k=1)
    assert float(out[0][0]) == 4.0
    assert PD.use_counts()["segment_agg"]["plain"] == 1


def test_cuda_session_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA rule cannot be shown")
    from tpu_cypher_torch import CypherSession

    with pytest.raises(PDEV.DeviceUnavailable):
        CypherSession.cuda()
    assert CypherSession.cuda(device="cpu").table_cls.__name__ == "CudaTable"
