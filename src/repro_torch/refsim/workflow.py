"""Heap-based reference workflow simulator (Pegasus/Airflow-style engine).

Counterpart of ``repro.refsim.workflow``: plain Python and numpy, sharing no
code with the port's pool engine.  Mirrors ``repro_torch.core.workflow``
semantics exactly for validation: completions
advance the clock; ready = all deps DONE; policies ``fcfs`` (blocking on
priority order), ``fcfs_fit`` / ``cpath`` (work-conserving on priority).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np


def simulate_workflow_reference(
    exec_time: Sequence[int],
    resources,
    dep_pairs: Sequence[Tuple[int, int]],
    pools,
    policy: str = "fcfs",
    priority=None,
) -> Dict[str, np.ndarray]:
    exec_time = np.maximum(np.asarray(exec_time, dtype=np.int64), 1)
    resources = np.asarray(resources, dtype=np.int64)
    if resources.ndim == 1:
        resources = resources[:, None]
    pools = np.asarray(pools, dtype=np.int64)
    n = len(exec_time)
    prio = (np.asarray(priority, dtype=np.int64)
            if priority is not None else np.arange(n, dtype=np.int64))

    deps: List[set] = [set() for _ in range(n)]
    dependents: List[list] = [[] for _ in range(n)]
    for t, d in dep_pairs:
        deps[t].add(d)
        dependents[d].append(t)

    unmet = np.array([len(d) for d in deps], dtype=np.int64)
    state = np.zeros(n, dtype=np.int64)  # 0 waiting, 1 running, 2 done
    start = np.full(n, -1, dtype=np.int64)
    finish = np.full(n, -1, dtype=np.int64)
    ready_at = np.zeros(n, dtype=np.int64)
    free = pools.copy()
    heap: List[tuple] = []
    clock = 0
    n_events = 0

    def select():
        ready = np.nonzero((state == 0) & (unmet == 0))[0]
        if len(ready) == 0:
            return -1
        order = ready[np.lexsort((ready, prio[ready]))]
        if policy == "fcfs":
            head = order[0]
            return head if np.all(resources[head] <= free) else -1
        for t in order:  # fcfs_fit / cpath: first (by priority) that fits
            if np.all(resources[t] <= free):
                return t
        return -1

    def sched_pass():
        nonlocal free
        while True:
            t = select()
            if t < 0:
                break
            state[t] = 1
            start[t] = clock
            finish[t] = clock + exec_time[t]
            free = free - resources[t]
            heapq.heappush(heap, (int(finish[t]), int(t)))

    sched_pass()
    while heap:
        clock = heap[0][0]
        n_events += 1
        while heap and heap[0][0] <= clock:
            _, t = heapq.heappop(heap)
            state[t] = 2
            free = free + resources[t]
            for u in dependents[t]:
                unmet[u] -= 1
                ready_at[u] = max(ready_at[u], clock)
        sched_pass()

    return {
        "exec_time": exec_time,
        "start": start,
        "finish": finish,
        "ready": ready_at,
        "wait": start - ready_at,
        "done": state == 2,
        "valid": np.ones(n, dtype=bool),
        "makespan": int(finish.max(initial=0)),
        "n_events": n_events,
    }
