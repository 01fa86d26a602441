"""Workflow DAG generators and the paper's JSON input format (Listing 2).

The PyTorch port's own copy of ``repro.traces.workflows`` (the port imports
nothing of the JAX package); both give the same arrays and pair lists for
the same seed.

Topologies follow the published structure of the workflows the paper uses
for validation (Juve et al. 2013 "Characterizing and Profiling Scientific
Workflows"; Pegasus workflow gallery):

- Montage: mProjectPP (W) -> mDiffFit (~3W edges between neighbours)
  -> mConcatFit (1) -> mBgModel (1) -> mBackground (W) -> mImgtbl (1)
  -> mAdd (1) -> mShrink (1) -> mJPEG (1).  Many short tasks.
- Galactic Plane: union of K independent Montage tile workflows feeding a
  final mosaic merge (paper Fig. 6 runs this at scale).
- SIPHT: parallel sRNA prediction chains (Patser x W -> concat), several
  independent annotation tasks, final sRNA annotate (paper Fig. 7).

All generators return plain dicts for ``core.workflow.make_taskset``, for
``workflow_to_trace`` (the cluster engine's job traces) and for the JSON
round trip below.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

WorkflowDict = Dict[str, object]


def _mk(exec_time, cpu, mem, dep_pairs) -> WorkflowDict:
    return {
        "exec_time": np.asarray(exec_time, dtype=np.int64),
        "resources": np.stack(
            [np.asarray(cpu, dtype=np.int64), np.asarray(mem, dtype=np.int64)], axis=1
        ),
        "dep_pairs": list(dep_pairs),
    }


def chain(n: int, exec_time: int = 100, cpu: int = 1, mem: int = 512) -> WorkflowDict:
    return _mk([exec_time] * n, [cpu] * n, [mem] * n, [(i, i - 1) for i in range(1, n)])


def fork_join(width: int, depth: int, *, seed: int = 0) -> WorkflowDict:
    """depth stages of `width` parallel tasks with barrier joins."""
    rng = np.random.default_rng(seed)
    n = depth * width + depth + 1
    et, cpu, mem, deps = [], [], [], []
    src = 0
    et.append(10); cpu.append(1); mem.append(256)
    prev_join = 0
    idx = 1
    for _ in range(depth):
        stage = list(range(idx, idx + width))
        for t in stage:
            et.append(int(rng.integers(50, 500)))
            cpu.append(int(rng.integers(1, 4)))
            mem.append(int(rng.choice([256, 512, 1024])))
            deps.append((t, prev_join))
        idx += width
        join = idx
        et.append(20); cpu.append(1); mem.append(256)
        for t in stage:
            deps.append((join, t))
        prev_join = join
        idx += 1
    return _mk(et, cpu, mem, deps)


def random_layered(
    n_tasks: int, n_layers: int, p_edge: float = 0.15, *, seed: int = 0
) -> WorkflowDict:
    """Random layered DAG (Gupta et al. 2017-style generator, paper §3.2)."""
    rng = np.random.default_rng(seed)
    layer = np.sort(rng.integers(0, n_layers, n_tasks))
    et = rng.integers(10, 1000, n_tasks)
    cpu = rng.integers(1, 8, n_tasks)
    mem = rng.choice([256, 512, 1024, 2048], n_tasks)
    deps: List[Tuple[int, int]] = []
    for i in range(n_tasks):
        cands = np.nonzero(layer < layer[i])[0]
        if len(cands) == 0:
            continue
        picks = cands[rng.random(len(cands)) < p_edge]
        if len(picks) == 0 and layer[i] > 0:
            picks = [int(rng.choice(cands))]
        deps.extend((i, int(j)) for j in picks)
    return _mk(et, cpu, mem, deps)


def montage_like(width: int = 20, *, seed: int = 0) -> WorkflowDict:
    rng = np.random.default_rng(seed)
    et, cpu, mem, deps = [], [], [], []

    def add(t, c, m):
        et.append(int(t)); cpu.append(int(c)); mem.append(int(m))
        return len(et) - 1

    project = [add(rng.integers(8, 25), 1, 512) for _ in range(width)]
    diff = []
    for i in range(width - 1):
        d = add(rng.integers(3, 12), 1, 256)
        deps += [(d, project[i]), (d, project[i + 1])]
        diff.append(d)
    concat = add(rng.integers(30, 80), 1, 1024)
    deps += [(concat, d) for d in diff]
    bgmodel = add(rng.integers(50, 150), 2, 2048)
    deps.append((bgmodel, concat))
    background = []
    for i in range(width):
        b = add(rng.integers(5, 15), 1, 512)
        deps += [(b, project[i]), (b, bgmodel)]
        background.append(b)
    imgtbl = add(rng.integers(10, 30), 1, 512)
    deps += [(imgtbl, b) for b in background]
    madd = add(rng.integers(100, 300), 4, 4096)
    deps.append((madd, imgtbl))
    shrink = add(rng.integers(20, 60), 1, 1024)
    deps.append((shrink, madd))
    jpeg = add(rng.integers(5, 15), 1, 256)
    deps.append((jpeg, shrink))
    return _mk(et, cpu, mem, deps)


def galactic_like(tiles: int = 8, width: int = 12, *, seed: int = 0) -> WorkflowDict:
    """Union of `tiles` Montage tile workflows + final mosaic merge."""
    et, cpu, mem, deps = [], [], [], []
    finals = []
    for k in range(tiles):
        sub = montage_like(width, seed=seed * 1000 + k)
        off = len(et)
        et.extend(sub["exec_time"].tolist())
        cpu.extend(sub["resources"][:, 0].tolist())
        mem.extend(sub["resources"][:, 1].tolist())
        deps.extend((t + off, d + off) for t, d in sub["dep_pairs"])
        finals.append(off + len(sub["exec_time"]) - 1)
    merge = len(et)
    et.append(200); cpu.append(4); mem.append(8192)
    deps.extend((merge, f) for f in finals)
    return _mk(et, cpu, mem, deps)


def sipht_like(width: int = 30, *, seed: int = 0) -> WorkflowDict:
    rng = np.random.default_rng(seed)
    et, cpu, mem, deps = [], [], [], []

    def add(t, c, m):
        et.append(int(t)); cpu.append(int(c)); mem.append(int(m))
        return len(et) - 1

    patser = [add(rng.integers(2, 10), 1, 256) for _ in range(width)]
    pconcat = add(rng.integers(10, 30), 1, 512)
    deps += [(pconcat, p) for p in patser]
    # independent analysis tasks (blast, RNAMotif, transterm, findterm, ...)
    analyses = [add(rng.integers(60, 3600), int(rng.integers(1, 4)), 1024)
                for _ in range(6)]
    srna = add(rng.integers(300, 1200), 2, 2048)
    deps += [(srna, a) for a in analyses]
    ffn = add(rng.integers(30, 120), 1, 512)
    deps.append((ffn, srna))
    annotate = add(rng.integers(100, 400), 2, 2048)
    deps += [(annotate, ffn), (annotate, pconcat)]
    return _mk(et, cpu, mem, deps)


# ---------------------------------------------------------------------------
# lowering: workflow DAG -> cluster job trace (DESIGN.md §13)
# ---------------------------------------------------------------------------

def workflow_to_trace(wf: WorkflowDict, *, submit: int = 0,
                      priority: str | None = None) -> Dict[str, object]:
    """Lower a workflow dict to a cluster job-trace dict with ``deps``.

    Tasks become cluster jobs: ``exec_time`` -> runtime/estimate, the cpu
    requirement (``resources[:, 0]``) -> node count (memory is a pool-model
    resource with no cluster analogue and is dropped), and the DAG edges
    ride along as ``deps`` pairs for ``make_jobset``.  Every task shares one
    ``submit`` time — release order is driven purely by the dependency
    structure, so wait = start - ready isolates queueing delay (paper
    Fig. 7).  ``priority="cpath"`` attaches critical-path-length priorities
    (longest path first) for the ``preempt`` policy.
    """
    et = np.asarray(wf["exec_time"], dtype=np.int64)
    nodes = np.asarray(wf["resources"], dtype=np.int64)
    if nodes.ndim == 2:
        nodes = nodes[:, 0]
    n = len(et)
    trace: Dict[str, object] = {
        "submit": np.full(n, int(submit), dtype=np.int64),
        "runtime": et.copy(),
        "estimate": et.copy(),
        "nodes": np.maximum(nodes, 1),
        "deps": [(int(t), int(d)) for t, d in wf["dep_pairs"]],
    }
    if priority == "cpath":
        from repro_torch.core.workflow import critical_path_length
        trace["priority"] = critical_path_length(et, wf["dep_pairs"])
    elif priority is not None:
        raise ValueError(f"unknown workflow priority scheme {priority!r}")
    return trace


# ---------------------------------------------------------------------------
# Paper Listing 2 JSON format
# ---------------------------------------------------------------------------

def to_json(wf: WorkflowDict, pools, *, policy: str = "Static",
            preemption: bool = False) -> str:
    """Serialize to the paper's JSON workflow input format (Listing 2)."""
    tasks = []
    dep_map: Dict[int, List[int]] = {}
    for t, d in wf["dep_pairs"]:
        dep_map.setdefault(int(t), []).append(int(d) + 1)  # paper ids are 1-based
    for i, et in enumerate(np.asarray(wf["exec_time"]).tolist()):
        tasks.append({
            "id": i + 1,
            "execution_time": int(et),
            "resources": {
                "cpu": int(wf["resources"][i][0]),
                "memory": int(wf["resources"][i][1]),
            },
            "dependencies": sorted(dep_map.get(i, [])),
        })
    pools = np.asarray(pools).tolist()
    doc = {
        "tasks": tasks,
        "resources_available": {"cpu": int(pools[0]), "memory": int(pools[1])},
        "scheduling_policy": policy,
        "preemption": preemption,
    }
    return json.dumps(doc, indent=1)


def from_json(text: str) -> Tuple[WorkflowDict, np.ndarray, str]:
    """Parse the paper's JSON workflow format -> (workflow, pools, policy)."""
    doc = json.loads(text)
    tasks = doc["tasks"]
    ids = [int(t["id"]) for t in tasks]
    remap = {tid: i for i, tid in enumerate(ids)}
    et = [int(t["execution_time"]) for t in tasks]
    cpu = [int(t["resources"].get("cpu", 1)) for t in tasks]
    mem = [int(t["resources"].get("memory", 0)) for t in tasks]
    deps = []
    for t in tasks:
        for d in t.get("dependencies", []):
            deps.append((remap[int(t["id"])], remap[int(d)]))
    ra = doc.get("resources_available", {"cpu": 1, "memory": 0})
    pools = np.asarray([int(ra.get("cpu", 1)), int(ra.get("memory", 0))], dtype=np.int64)
    return _mk(et, cpu, mem, deps), pools, doc.get("scheduling_policy", "Static")
