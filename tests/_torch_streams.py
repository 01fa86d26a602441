"""Shared helpers of the port's stream tests (node failures, serving and
malleable jobs): a port scenario as the reference's, and the bit-for-bit
comparison of a port result with ``repro.api.run`` and
``repro.api.run_ref``."""

import dataclasses

import numpy as np

import repro_torch as rt
from repro import api

# per-job columns the reference simulator returns unpadded; the capacity
# log and the event log are whole arrays in every backend
WHOLE = ("cap_online", "cap_time", "ev_time", "ev_free", "ev_lfb")
SCALARS = ("makespan", "n_events")


def _fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def jax_spec(x):
    """A port spec (scenario, trace, injected trace, topology, failure
    model, service trace, class, autoscaler, malleable model) as the
    reference's; other values as they are."""
    if isinstance(x, rt.Scenario):
        return api.Scenario(**{k: jax_spec(v) for k, v in _fields(x).items()
                               if v is not None})
    if isinstance(x, rt.ServiceTrace):
        kw = _fields(x)
        kw["classes"] = tuple(jax_spec(c) for c in x.classes)
        kw["autoscale"] = jax_spec(x.autoscale)
        return api.ServiceTrace(**kw)
    if isinstance(x, rt.Topology):
        return api.Topology(x.kind, x.shape)
    if isinstance(x, rt.ArrayTrace):
        return api.ArrayTrace(**_fields(x))
    if isinstance(x, rt.InjectedTrace):
        return api.InjectedTrace(base=jax_spec(x.base), jobs=x.jobs)
    for name in ("FailureModel", "ServiceClass", "AutoscalePolicy",
                 "SyntheticTrace", "SwfTrace", "WorkflowTrace",
                 "MalleableModel"):
        if isinstance(x, getattr(rt, name)):
            return getattr(api, name)(**_fields(x))
    return x


def diff(port: dict, other: dict, keys=None) -> list:
    """The keys where two result dicts differ: per-job columns over the
    other's rows (the reference simulator's are unpadded), whole logs and
    scalars exactly."""
    bad = []
    for k in keys or other:
        if k not in port:
            bad.append(f"{k} missing")
            continue
        a, b = np.asarray(port[k]), np.asarray(other[k])
        if a.ndim == 1 and k not in WHOLE and b.shape != a.shape:
            a = a[:len(b)]
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(k)
    return bad


def same_summary(a: dict, b: dict) -> bool:
    """Two summaries with the same keys and every value equal, a NaN (the
    percentile of a class with no finished job) equal to a NaN."""
    return set(a) == set(b) and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def assert_matches_jax(res, scn=None, *, ref: bool = True, summary=True):
    """A port ``Result`` against ``repro.api.run`` of the same scenario,
    every column and the summary bit for bit, and (``ref``) against
    ``repro.api.run_ref`` on the columns it returns."""
    scn = jax_spec(res.scenario if scn is None else scn)
    got = res.to_np()
    want = api.run(scn)
    assert diff(got, want.to_np()) == [], scn
    assert set(got) == set(want.to_np())
    if summary:
        assert same_summary(res.summary(), want.summary()), scn
    if ref:
        r = api.run_ref(scn)
        keys = [k for k in r.to_np() if k in got and k not in (
            "valid", "ev_time", "ev_free", "ev_lfb")]
        assert diff(got, r.to_np(), keys) == [], scn
    return want
