"""Scheduling-policy selectors of the PyTorch engine.

Counterpart of ``repro.core.policies``, with the same semantics: each
selector returns the row of the waiting job that starts next, or -1.

- FCFS / SJF / LJF: blocking head of the (re)ordered queue.
- BestFit: among waiting jobs that fit, the one leaving the fewest nodes
  free (ties: FCFS order).
- Backfill: EASY.  The FCFS head starts if it fits; otherwise the first
  FCFS-ordered waiting job that fits now and either ends by the head's
  shadow time or uses only the shadow's extra nodes.
- Preempt: queue order (priority, submit, row); the head starts if it fits
  in the free nodes plus those of strictly-lower-priority running jobs.

Every argmin is one fused selection of the job table's ``selector``: the
``queue_select`` kernel builds the key and the mask of a mode from the
table's columns and the job states, and returns ``(index, score)`` as
Python ints (the plain version on a CPU table).  The shadow walk is one
``shadow_walk`` launch.  The reference's device ``while_loop``s become host
loops over these calls.  Every primary key here (submit, estimate,
-estimate, free - nodes, reservation times) stays below ``BIG``, where the
kernel and the reference's jnp argmin agree exactly.

A selector is written once, as a generator over one member's host columns
(``host``: the table's numpy rows) and host scalars (``st``: ``clock``,
``free``): it yields each request it needs answered and receives the answer
back.  A request is a tuple whose first item is its kind:

- ``(SELECT, mode, params)`` -> ``(index, score)``, a fused selection with
  the scalars ``params`` (``ref.params``);
- ``(WALK, params, redo)`` -> ``(shadow, extra, k_row)``, the shadow walk
  (``redo``: a walk made again after an overdraw of ``extra``);
- ``(RECLAIM, priority)`` -> the nodes of the running jobs of priority
  strictly above ``priority`` (less important);
- and, from the engine's passes, ``(START, idx)``, ``(SUSPEND, idx)`` and
  ``(PREFIX,)``, which change the state and answer ``None``.

A solo run answers each request at once (:func:`answer`, :func:`drive`); an
ensemble gathers one request from every member still in its pass and
answers each kind with one launch for all of them
(``core.engine.simulate_batch``).  So every member makes exactly the
sequence of calls its solo run makes.
"""

from __future__ import annotations

import torch

from repro_torch.core.jobs import RUNNING, JobSet, SimState
from repro_torch.kernels.queue_select import ref
from repro_torch.kernels.queue_select.ops import shadow_walk

# request kinds (see the module docstring)
SELECT, WALK, RECLAIM = "select", "walk", "reclaim"
START, SUSPEND, PREFIX = "start", "suspend", "prefix"
NO_PARAMS = ref.params()


def backfill_shadow(jobs: JobSet, state: SimState,
                    head_need: int) -> tuple[int, int, int]:
    """EASY shadow reservation for a blocked head needing ``head_need``
    nodes: ``(shadow, extra, k_row)``.

    Walks the running jobs' releases (walltime estimates, clamped past the
    clock) in (time, row) order, adding their nodes to the free count until
    the head is covered.  ``shadow`` is that release time, ``extra`` the
    spare nodes then, ``k_row`` the release that covered the head (-1, with
    ``shadow = BIG`` and ``extra = free``, when the running set cannot).  As
    in the reference, at least one release is always counted.
    """
    return shadow_walk(jobs.selector, state.jstate, state.rsv_finish,
                       state.clock, state.free, head_need)


def placeable(st) -> int:
    """The largest job a selection may start now (the reference's
    ``placeable_cap``): the largest free run when the state tracks it
    (``contiguous``), else the free counter."""
    return st.free if st.lfb is None else st.lfb


def walk_request(st, head_need: int, redo: bool = False) -> tuple:
    return (WALK, ref.params(clock=st.clock, free=st.free,
                             head_need=head_need), redo)


def _blocking_head(host, mode: int, cap: int):
    head, _ = yield (SELECT, mode, NO_PARAMS)
    if head >= 0 and int(host["nodes"][head]) <= cap:
        return head
    return -1


def select_fcfs(host, st, cap: int):
    return (yield from _blocking_head(host, ref.HEAD_SUBMIT, cap))


def select_sjf(host, st, cap: int):
    return (yield from _blocking_head(host, ref.HEAD_ESTIMATE, cap))


def select_ljf(host, st, cap: int):
    return (yield from _blocking_head(host, ref.HEAD_NEG_ESTIMATE, cap))


def select_bestfit(host, st, cap: int):
    return (yield (SELECT, ref.BESTFIT,
                   ref.params(free=st.free, cap=cap)))[0]


def select_backfill(host, st, cap: int):
    head, _ = yield (SELECT, ref.HEAD_SUBMIT, NO_PARAMS)
    if head < 0:
        return -1
    head_need = int(host["nodes"][head])
    if head_need <= cap:
        return head
    # some non-head waiting job must fit before the shadow walk can pay
    if (yield (SELECT, ref.ANY_FIT,
               ref.params(cap=cap, exclude=head)))[0] < 0:
        return -1
    shadow, extra, _k_row = yield walk_request(st, head_need)
    return (yield (SELECT, ref.BACKFILL_CAND, ref.params(
        clock=st.clock, free=st.free, cap=cap, shadow=shadow, extra=extra,
        exclude=head)))[0]


def select_preempt(host, st, cap: int):
    """Priority scheduling with preemption; ``cap`` is unused (the reclaim
    test counts free nodes).  Both stages are fused selections: the least
    priority over the waiting jobs (the reference's
    ``min(where(waiting, priority, BIG))``, taken over every row so that it
    agrees for priorities above ``BIG`` too), then the FCFS head of that
    tier."""
    _, best_p = yield (SELECT, ref.PREEMPT_TIER, NO_PARAMS)
    head, _ = yield (SELECT, ref.PREEMPT_HEAD, ref.params(tier=best_p))
    if head < 0:
        return -1
    reclaimable = yield (RECLAIM, int(host["priority"][head]))
    if int(host["nodes"][head]) <= st.free + reclaimable:
        return head
    return -1


# indexed by policy id (FCFS, SJF, LJF, BESTFIT, BACKFILL, PREEMPT)
SELECTORS = (select_fcfs, select_sjf, select_ljf, select_bestfit,
             select_backfill, select_preempt)


def answer(jobs: JobSet, state: SimState, req: tuple):
    """The solo answer to a SELECT, WALK or RECLAIM request."""
    kind = req[0]
    if kind is SELECT:
        return jobs.selector.select(req[1], state.jstate, *req[2][:-1])
    if kind is WALK:
        p = req[1]
        return shadow_walk(jobs.selector, state.jstate, state.rsv_finish,
                           p[0], p[1], p[-1])
    if kind is RECLAIM:
        lower = (state.jstate == RUNNING) & (jobs.priority > req[1])
        return int(torch.sum(torch.where(lower, jobs.nodes, 0)))
    raise ValueError(f"no solo answer to a {kind!r} request")


def drive(gen, respond):
    """Run the generator ``gen`` to its end, answering each request it
    yields with ``respond(request)``; returns the generator's value."""
    ans = None
    while True:
        try:
            req = gen.send(ans)
        except StopIteration as stop:
            return stop.value
        ans = respond(req)


def select(policy: int, jobs: JobSet, state: SimState,
           cap: int | None = None) -> int:
    """Dispatch on the policy id, clamped to the table as in the reference;
    ``cap`` defaults to the state's placeable size (:func:`placeable`)."""
    cap = placeable(state) if cap is None else cap
    gen = SELECTORS[min(max(int(policy), 0), len(SELECTORS) - 1)](
        jobs.host, state, cap)
    return drive(gen, lambda req: answer(jobs, state, req))
