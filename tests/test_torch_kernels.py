"""The port's kernel modules held against the JAX package, on the CPU.

For each of the three kernels on the CSR expand slice, the plain PyTorch
version (what a CPU tensor runs, and what the CUDA kernel is held to on the
card by ``chip_smoke.py``) must be bit-identical — values AND dtypes — to
the reference's jnp formulation and to its Pallas kernel run in interpret
mode, on the same seeded numpy inputs: empty, all-masked, single-bucket and
larger shapes. The gate's tier rule is covered too: the CPU tier, the
counters, a CUDA-tier launch error that raises (the launch function is
monkeypatched) and is never memoized, and the ``fallback`` tier for an
ineligible call.
"""

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

from tpu_cypher_torch import errors as PERR
from tpu_cypher_torch.backend.cuda import device as PDEV
from tpu_cypher_torch.backend.cuda import jit_ops as PJ
from tpu_cypher_torch.backend.cuda.hopper import aggregate as PA
from tpu_cypher_torch.backend.cuda.hopper import dispatch as PD
from tpu_cypher_torch.backend.cuda.hopper import expand as PE
from tpu_cypher_torch.backend.cuda.hopper import frontier as PF

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
    assert set(reg) == {"expand_rows", "frontier_deg_sum", "segment_agg"}
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
