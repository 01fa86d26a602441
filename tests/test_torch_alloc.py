"""The port's allocation primitives (on the CPU) against ``repro.alloc``.

The same seeded numpy inputs go to both packages and the results must be
equal (integers): the three machine constructors' ``to_host()`` and their
refusals; every placer, ``placeable_cap``, ``free_count``,
``largest_free_run``, ``group_span`` and ``alloc_fingerprint`` on random
occupancy maps, ``need > free`` and ``contiguous``'s fallback included;
``place_batch`` against solo placements; ``dilate`` and ``dilate_host`` up
to saturation; the strategy and contention canonicalizers; and the
consistency checks of ``Scenario``, ``simulate`` and ``simulate_ensemble``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.alloc as R
import repro_torch as rt
from repro import api
from repro_torch import alloc as A
from repro_torch.api import build_jobset
from repro_torch.core import engine
from repro_torch.core.parallel import simulate_ensemble, stack_jobsets

MACHINES = [("linear", (37,), {"group_size": 5}), ("linear", (64,), {}),
            ("mesh2d", (6, 7), {}), ("mesh2d", (1, 9), {}),
            ("dragonfly", (5, 4), {}), ("dragonfly", (16, 8), {})]


def _pair(kind, args, kw):
    return (getattr(A, kind)(*args, **kw, device="cpu"),
            getattr(R, kind)(*args, **kw))


def _owner(rng, n, busy, J=50):
    """A random occupancy map: a share ``busy`` of the nodes owned."""
    return np.where(rng.random(n) < busy, rng.integers(0, J, n),
                    -1).astype(np.int32)


@pytest.mark.parametrize("kind,args,kw", MACHINES)
def test_machines_match_jax(kind, args, kw):
    port, ref = _pair(kind, args, kw)
    a, b = port.to_host(), ref.to_host()
    assert set(a) == set(b) and a["n_groups"] == b["n_groups"]
    for k in ("group", "group_start", "group_size", "coord"):
        assert a[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.n_nodes == ref.n_nodes


def test_machines_refuse_what_jax_refuses():
    for args in ((2 ** 15, 1), (0, 4)):
        with pytest.raises(ValueError):
            R.dragonfly(*args)
        with pytest.raises(ValueError):
            A.dragonfly(*args, device="cpu")
    with pytest.raises(ValueError, match="nondecreasing"):
        A.machine._from_groups(np.array([0, 1, 0]), np.zeros((3, 2)), "cpu")
    with pytest.raises(ValueError, match="int32 sort keys"):
        A.linear(2 ** 15, device="cpu")


@pytest.mark.parametrize("kind,args,kw", MACHINES)
@pytest.mark.parametrize("strategy", (0, 1, 2, 3))
def test_placers_match_jax(kind, args, kw, strategy):
    port, ref = _pair(kind, args, kw)
    n = port.n_nodes
    rng = np.random.default_rng(strategy * 100 + n)
    for busy in (0.0, 0.2, 0.5, 0.8, 1.0):
        for _ in range(6):
            own = _owner(rng, n, busy)
            n_free = int((own < 0).sum())
            # needs up to one past the free count (need > free), and 1
            for need in {1, n_free, n_free + 1, int(rng.integers(1, n + 1))}:
                need = max(need, 1)
                got = A.place(strategy, port, torch.from_numpy(own), need)
                want = np.asarray(R.place(jnp.int32(strategy), ref,
                                          jnp.asarray(own), jnp.int32(need)))
                np.testing.assert_array_equal(got.numpy(), want)
                assert int(got.sum()) == min(need, n_free)
                assert int(A.group_span(port, got)) == int(
                    R.group_span(ref, jnp.asarray(want)))
                assert [int(x) for x in A.alloc_fingerprint(got)] == [
                    int(x) for x in R.alloc_fingerprint(jnp.asarray(want))]
            t = torch.from_numpy(own)
            assert int(A.placeable_cap(strategy, t)) == int(
                R.placeable_cap(jnp.int32(strategy), jnp.asarray(own)))
            assert int(A.free_count(t)) == int(R.free_count(jnp.asarray(own)))
            assert int(A.largest_free_run(t)) == int(
                R.largest_free_run(jnp.asarray(own)))


def test_contiguous_falls_back_to_simple():
    port, ref = _pair("linear", (12,), {"group_size": 4})
    # free runs of 2, 3 and 1: no run of 4 fits, so the four lowest free ids
    own = np.array([-1, -1, 0, -1, -1, -1, 1, 1, -1, 2, 2, 2], np.int32)
    got = A.place(A.CONTIGUOUS, port, torch.from_numpy(own), 4).numpy()
    np.testing.assert_array_equal(np.nonzero(got)[0], [0, 1, 3, 4])
    np.testing.assert_array_equal(got, np.asarray(R.place(
        jnp.int32(1), ref, jnp.asarray(own), jnp.int32(4))))
    # best fit: the run of 3 takes a 3-node job, the run of 2 a 2-node one
    for need, first in ((3, 3), (2, 0), (1, 8)):
        got = A.place(A.CONTIGUOUS, port, torch.from_numpy(own), need)
        assert int(A.alloc_fingerprint(got)[0]) == first
    assert int(A.largest_free_run(torch.from_numpy(own))) == 3


@pytest.mark.parametrize("kind,args,kw", MACHINES[:3])
def test_place_batch_equals_solo_placements(kind, args, kw):
    port, _ = _pair(kind, args, kw)
    n = port.n_nodes
    rng = np.random.default_rng(n)
    for strategies in ([0, 1, 2, 3, 3, 1], [2, 2, 2], [1]):
        own = np.stack([_owner(rng, n, b)
                        for b in rng.random(len(strategies))])
        need = rng.integers(1, n + 1, len(strategies)).astype(np.int32)
        got = A.place_batch(strategies, port, torch.from_numpy(own),
                            torch.from_numpy(need))
        for r, s in enumerate(strategies):
            np.testing.assert_array_equal(
                got[r].numpy(), A.place(s, port, torch.from_numpy(own[r]),
                                        int(need[r])).numpy())
        span = A.group_span(port, got)
        first, asum = A.alloc_fingerprint(got)
        for r in range(len(strategies)):
            assert int(span[r]) == int(A.group_span(port, got[r]))
            assert (int(first[r]), int(asum[r])) == tuple(
                int(x) for x in A.alloc_fingerprint(got[r]))


CON_CASES = [(0, 1), (1, 5), (3, 7), (1023, 1), (1, 32767), (1023, 32767)]


@pytest.mark.parametrize("num,den", CON_CASES)
def test_dilate_matches_jax(num, den):
    rng = np.random.default_rng(num * 7 + den)
    rem = np.concatenate([rng.integers(1, 10 ** 6, 50),
                          [1, 2 ** 20, 2 ** 29, 2 ** 30 - 1]]).astype(np.int32)
    span = np.concatenate([rng.integers(0, 40, 50),
                           [2 ** 15 - 1, 1, 0, 2 ** 15 - 1]]).astype(np.int32)
    for con, rcon in ((A.Contention.make(num, den), R.Contention.make(num, den)),
                      (A.Contention.off(), R.Contention.off())):
        got = A.dilate(con, torch.from_numpy(rem), torch.from_numpy(span))
        want = np.asarray(R.dilate(rcon, jnp.asarray(rem), jnp.asarray(span)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    # saturation at 2**30 - 1, and the host mirror
    assert int(want.max()) <= 2 ** 30 - 1
    for r, s in zip(rem.tolist(), span.tolist()):
        assert A.dilate_host(num, den, r, s) == R.dilate_host(num, den, r, s)
    # one contention a member, as the ensemble stacks them
    cons = [A.Contention.make(num, den), A.Contention.off()] * 27
    stacked = A.Contention.stack(cons, "cpu")
    got = A.dilate(stacked, torch.from_numpy(rem), torch.from_numpy(span))
    for i, c in enumerate(cons):
        assert int(got[i]) == int(A.dilate(c, torch.from_numpy(rem[i:i + 1]),
                                           torch.from_numpy(span[i:i + 1])))


def test_contention_canonical_matches_jax():
    for value in (None, (1, 5), (0, 3)):
        a, b = A.Contention.canonical(value), R.Contention.canonical(value)
        assert (a.enabled, a.alpha_num, a.alpha_den) == tuple(
            int(x) for x in (b.enabled, b.alpha_num, b.alpha_den))
    c = A.Contention.make(2, 9)
    assert A.Contention.canonical(c) is c
    for bad in ((1, 0), (1, 2 ** 15), (2 ** 10, 1), (-1, 5)):
        with pytest.raises(ValueError):
            A.Contention.make(*bad)
        with pytest.raises(ValueError):
            R.Contention.make(*bad)
    with pytest.raises(TypeError):
        A.Contention.canonical(1.5)


@pytest.mark.parametrize("value", [
    "simple", "TOPO", 2, np.int64(3), None, ["spread", 0, "contiguous"],
    ("topo",), np.array(["simple", "spread"], dtype=object),
    np.array([3, 1]), np.array(2)])
def test_canonical_id_matches_jax(value):
    got = A.canonical_id(value)
    want = R.canonical_id(value)
    if isinstance(got, list):
        assert got == np.asarray(want).tolist()
    else:
        assert got == int(want)


@pytest.mark.parametrize("bad", ["fastest", 4, -1, ["simple", 9]])
def test_canonical_id_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        R.canonical_id(bad)
    with pytest.raises(ValueError):
        A.canonical_id(bad)


def test_consistency_checks_raise():
    trace = rt.SyntheticTrace(n_jobs=10)
    topo = rt.Topology.dragonfly(2, 4)
    for kw in ({"alloc": "topo"}, {"contention": (1, 5)}):
        with pytest.raises(ValueError, match="require topology"):
            rt.Scenario(trace=trace, total_nodes=8, **kw)
        with pytest.raises(ValueError, match="require topology"):
            api.Scenario(trace=api.SyntheticTrace(n_jobs=10), total_nodes=8,
                         **kw)
    with pytest.raises(ValueError, match="8 nodes but total_nodes=9"):
        rt.Scenario(trace=trace, total_nodes=9, topology=topo)
    with pytest.raises(ValueError, match="total_nodes is required"):
        rt.Scenario(trace=trace)
    assert rt.Scenario(trace=trace, topology=topo).total_nodes == 8
    jobs = build_jobset(rt.Scenario(trace=trace, total_nodes=8), device="cpu")
    machine = topo.build("cpu")
    with pytest.raises(ValueError, match="require machine"):
        rt.simulate(jobs, "fcfs", 8, alloc="topo", device="cpu")
    with pytest.raises(ValueError, match="8 nodes but total_nodes=16"):
        rt.simulate(jobs, "fcfs", 16, machine=machine, device="cpu")
    with pytest.raises(ValueError, match="one allocation strategy"):
        engine.make_alloc_ctx(machine, ["simple", "topo"], None)
    stacked = stack_jobsets([jobs, jobs])
    with pytest.raises(ValueError, match="require machine"):
        simulate_ensemble(stacked, ["fcfs"] * 2, [8, 8], contention=(1, 5),
                          device="cpu")
    with pytest.raises(ValueError, match="total_nodes_b contains"):
        simulate_ensemble(stacked, ["fcfs"] * 2, [8, 16], machine=machine,
                          device="cpu")
    with pytest.raises(ValueError, match="for 2 members"):
        simulate_ensemble(stacked, ["fcfs"] * 2, [8, 8], machine=machine,
                          alloc_b=["topo"], device="cpu")
    with pytest.raises(ValueError, match="unknown topology kind"):
        rt.Topology("torus", (2, 2)).build("cpu")


def test_machine_defaults_to_cuda():
    if torch.cuda.is_available():
        assert A.linear(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.linear(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.run(rt.Scenario(trace=rt.SyntheticTrace(n_jobs=5),
                               topology=rt.Topology.linear(8)))
