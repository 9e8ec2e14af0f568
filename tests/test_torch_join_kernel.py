"""The ``join_probe`` kernel tier's ctypes arguments, on the CPU.

``hash_probe.cu`` runs only on the card, where ``chip_smoke.py`` holds it
to its plain versions. Here a torch emulation of its two kernels stands in
for the loaded library and reads the wrappers' raw arguments as the
kernels read them: the build keys gathered through the sorted order at
their own width (int8 and int32 sign-extended, bool zero-extended, float64
as the bits of ``x + 0.0``), the probe keys and up to two mask pointers,
the table with its bound row, and the total. The build inserts its run
starts in a random order (on the card the order in which the CASes land
decides it), so its table differs from ``hash_build``'s slot by slot and is
held to it by ``table_invariants``; the probe's ``lo``, counts and total
must equal the port's ``jit_ops.join_probe`` bit for bit and the JAX
package's ``jit_ops.join_probe`` under the contract of
``tests/test_torch_join.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from tpu_cypher.backend.tpu import jit_ops as RJ

from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.hopper import join as PK

torch.set_num_threads(1)

TAG = 7 << 54  # graph-tagged ids: keys far past int32
# the kernels' key-type codes, as ctypes reads them
CTYPES = {1: ctypes.c_uint8, 2: ctypes.c_int8, 3: ctypes.c_int32, 4: ctypes.c_int64,
          5: ctypes.c_double}


@pytest.fixture(autouse=True)
def _clean():
    PDEV.use("cpu")
    PD.reset()
    yield
    PD.reset()


def _t(a):
    return torch.from_numpy(np.array(a))


def _raw(ptr, ctype, n):
    """``n`` values of ``ctype`` at a host address, as a kernel reads them."""
    if n == 0:
        return torch.from_numpy(np.zeros(0, np.dtype(ctype)))
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(ptr)).copy())


def _store(ptr, t):
    ctypes.memmove(ptr, t.contiguous().data_ptr(), t.numel() * t.element_size())


def _raw_keys(ptr, code, n):
    """(int64 keys, key validity) of ``n`` keys of type ``code``."""
    x = _raw(ptr, CTYPES[code], n)
    if code == 5:
        return (x + 0.0).view(torch.int64), ~torch.isnan(x)
    return x.to(torch.int64), torch.ones(n, dtype=torch.bool)


class _JoinKernelEmulation:
    """``hash_probe.cu`` in torch. The build zeroes the table (the memset),
    then places each run start's key, first position and run length at the
    first free slot on its linear path, the starts taken in a random
    order, and writes the largest offset to the bound row."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def hash_build_launch(self, rd, code, order, n, log2_size, table, stream):
        size = 1 << log2_size
        t = torch.zeros(size + 1, 4, dtype=torch.int32)
        if n:
            pos = _raw(order, ctypes.c_int64, n)
            keys = _raw_keys(rd, code, int(pos.max()) + 1)[0][pos]
            start = torch.ones(n, dtype=torch.bool)
            start[1:] = keys[1:] != keys[:-1]
            firsts = torch.nonzero(start).flatten().tolist() + [n]
            hashes = PK.slot_hash(keys, size).tolist()
            key_col = t.view(torch.int64)[:, 0]
            bound = 0
            for j in self.rng.permutation(len(firsts) - 1):
                i = firsts[j]
                off = 0
                while int(t[(hashes[i] + off) & (size - 1), 3]):
                    off += 1
                s = (hashes[i] + off) & (size - 1)
                key_col[s] = keys[i]
                t[s, 2], t[s, 3] = i, firsts[j + 1] - i
                bound = max(bound, off)
            t[size, 0] = bound
        _store(table, t)
        return 0

    def hash_probe_scratch_bytes(self, device):
        return 16

    def hash_probe_launch(self, table, log2_size, q, code, m1, m2, nq, lo, counts, total,
                          scratch, stream):
        size = 1 << log2_size
        t = _raw(table, ctypes.c_int32, 4 * (size + 1)).reshape(size + 1, 4)
        x, live = _raw_keys(q, code, nq)
        for m in (m1, m2):
            if m:
                live &= _raw(m, ctypes.c_uint8, nq) != 0
        keys = t[:size].contiguous().view(torch.int64)[:, 0]
        h = PK.slot_hash(x, size)
        lo_t = torch.zeros(nq, dtype=torch.int64)
        c_t = torch.zeros(nq, dtype=torch.int64)
        for off in range(int(t[size, 0]) + 1):
            s = (h + off) & (size - 1)
            run = t[s, 3].to(torch.int64)
            hit = live & (run > 0) & (keys[s] == x)
            lo_t = torch.where(hit, t[s, 2].to(torch.int64), lo_t)
            c_t = torch.where(hit, run, c_t)
            live = live & ~hit & (run > 0)
        _store(lo, lo_t)
        _store(counts, c_t)
        _store(total, c_t.sum().reshape(1))
        return 0


def _as_cuda(launch):
    def wrapped(name, kernel_fn, plain_fn, *, device, eligible=True):
        return launch(name, kernel_fn, plain_fn, device=torch.device("cuda", 0),
                      eligible=eligible)

    return wrapped


# no subnormal: XLA on the CPU flushes them to zero, so the reference would
# join 5e-324 with 0.0 (chip_smoke.py holds the kernel to the plain
# version on one)
FV = np.array([-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, np.nan, 1e300])

# (case, key kind, probe masks)
CASES = [
    ("int64", "i64", 0), ("int64 one mask", "i64", 1), ("int64 two masks", "i64", 2),
    ("int64 three masks", "i64", 3), ("int32 codes", "i32", 1), ("int8", "i8", 2),
    ("bool", "bool", 0), ("float64", "f64", 2), ("empty build", "i64", 1),
    ("all-invalid probe", "i64", 1), ("single key repeated", "i64", 0),
]


def _case(case, kind, nmasks, rng, nr=600, n=1000):
    """(rd, rvalid, ld, probe masks) from one seed: keys with collisions in
    a table of 1,024 slots, negative keys where the type has them."""
    if kind == "i64":
        rd = rng.integers(0, 300, nr) + TAG
        rd[: nr // 5] = -rd[: nr // 5]
        ld = np.concatenate([rd[rng.integers(0, nr, n // 2)], rng.integers(0, 400, n // 2) + TAG])
    elif kind == "i32":
        rd = rng.integers(-60, 200, nr).astype(np.int32)
        ld = rng.integers(-80, 260, n).astype(np.int32)
    elif kind == "i8":
        rd = rng.integers(-100, 100, nr).astype(np.int8)
        ld = rng.integers(-128, 128, n).astype(np.int8)
    elif kind == "bool":
        rd, ld = rng.random(nr) < 0.3, rng.random(n) < 0.5
    else:
        base = FV[rng.integers(0, FV.shape[0], nr)]
        rd = np.where(rng.random(nr) < 0.5, base, base + rng.integers(1, 200, nr))
        ld = np.concatenate([rd[rng.integers(0, nr, n // 2)], FV[rng.integers(0, FV.shape[0], n // 2)]])
    if case == "single key repeated":
        rd = np.full(nr, 5 << 54, np.int64)
        ld = np.where(rng.random(n) < 0.5, 5 << 54, 6 << 54).astype(np.int64)
    rvalid = rng.random(nr) < (0.0 if case == "empty build" else 0.9)
    masks = [rng.random(n) < (0.0 if case == "all-invalid probe" else 0.9)
             for _ in range(nmasks)]
    return rd, rvalid, ld, masks


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case,kind,nmasks", CASES)
def test_join_kernel_arguments_emulated_match_reference(monkeypatch, case, kind, nmasks, seed):
    """The kernel tier through the gate on a CUDA-tagged call, with the
    emulation behind ``_lib``: its ``lo``, counts and total equal the
    port's plain version bit for bit and the reference's under the
    contract, and its table keeps ``table_invariants``."""
    emul = _JoinKernelEmulation(seed)
    monkeypatch.setattr(PK, "_lib", lambda: emul)
    monkeypatch.setattr(PK._build, "stream", lambda dev: 0)
    monkeypatch.setattr(PK._build, "scratch_ptr", lambda kernel, dev, nbytes, stream: 0)
    monkeypatch.setattr(PK, "hash_build_cuda", PK._build_launch)
    monkeypatch.setattr(PK, "hash_probe_cuda", PK._probe_launch)
    monkeypatch.setattr(PK.dispatch, "launch", _as_cuda(PD.launch))
    rng = np.random.default_rng(seed)
    rd, rvalid, ld, masks = _case(case, kind, nmasks, rng)
    is_f64, is_bool = kind == "f64", kind == "bool"
    rd_s, r_order, nv = RJ.join_build(np.asarray(rd), (np.asarray(rvalid),), is_f64=is_f64,
                                      is_bool=is_bool)
    nvalid = int(nv)
    want_ref = RJ.join_probe(rd_s, r_order, np.asarray(ld), tuple(masks), nvalid=nvalid,
                             is_f64=is_f64, is_bool=is_bool)
    p_rd_s, p_order, p_nv = PJ.join_build(_t(rd), (_t(rvalid),), is_f64=is_f64,
                                          is_bool=is_bool)
    assert int(p_nv) == nvalid
    lvalids = tuple(_t(m) for m in masks)
    want = PJ.join_probe(p_rd_s, p_order, _t(ld), lvalids, nvalid, is_f64=is_f64,
                         is_bool=is_bool)
    got = PK.join_probe(p_rd_s, p_order, _t(ld), lvalids, nvalid, is_f64=is_f64,
                        is_bool=is_bool)
    assert PD.use_counts()["join_probe"] == {"kernel": 1, "plain": 0, "fallback": 0}
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == w.dtype and torch.equal(g, w), (case, i)
    r_idx, lo, counts, total = (np.asarray(x) for x in want_ref)
    assert np.array_equal(counts, got[2].numpy()) and int(total) == int(got[3])
    assert np.array_equal(r_idx[:nvalid], got[0].numpy())
    hit = counts > 0
    assert np.array_equal(lo[hit], got[1].numpy()[hit]) and not got[1].numpy()[~hit].any()
    if case not in ("empty build", "all-invalid probe"):
        assert int(total) > 0
    # the build's table, held by what the probe reads
    size = PK.table_size(nvalid)
    table = PK._build_launch(p_rd_s, p_order, nvalid, size, is_f64)
    keys = PK.plain_keys(p_rd_s, p_order, nvalid, _t(ld), lvalids, is_f64)[0]
    assert table.shape == (size + 1, 4)
    assert PK.table_invariants(table[:size], int(table[size, 0]), keys) == [], case


def test_table_invariants_find_a_broken_table():
    """Each invariant, broken on its own in a table built by ``hash_build``
    from colliding keys, is reported."""
    rng = np.random.default_rng(4)
    unique = rng.integers(0, 1 << 40, 60) + TAG
    keys = torch.sort(_t(unique[rng.integers(0, 60, 200)])).values
    table, bound = PK.hash_build(keys, 128)
    assert bound > 0 and PK.table_invariants(table, bound, keys) == []
    assert PK.table_invariants(table, bound + 1, keys)       # not the largest offset
    assert PK.table_invariants(table, bound - 1, keys)       # a key past the bound
    occupied = torch.nonzero(table[:, 3]).flatten()
    bad = table.clone()
    bad[occupied[0], 2] += 1                                  # a wrong first position
    assert PK.table_invariants(bad, bound, keys)
    bad = table.clone()
    bad[occupied[0]] = 0                                      # a key missing
    assert PK.table_invariants(bad, bound, keys)
    # a key moved one slot on, past the free slot it leaves on its path
    size = table.shape[0]
    offs = (occupied - PK.slot_hash(table.view(torch.int64)[occupied, 0], size)) & (size - 1)
    free_next = table[(occupied + 1) % size, 3] == 0
    s = int(occupied[(offs == 0) & free_next][0])
    bad = table.clone()
    bad[(s + 1) % size], bad[s] = table[s], 0
    assert PK.table_invariants(bad, bound, keys)
