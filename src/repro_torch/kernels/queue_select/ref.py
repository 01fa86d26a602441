"""Plain PyTorch versions of the ``queue_select`` kernel family.

- :func:`queue_select_reference`: the masked lexicographic argmin over a
  given score vector and mask (the TPU kernel's function).
- :func:`fused_select_reference`: the same argmin with the key and the
  mask built from the job table's columns, one *mode* for each argmin of
  the engine's selectors and batched passes.
- :func:`shadow_walk_reference`: the EASY shadow walk over the running
  jobs' releases.
- :func:`fused_select_batched_reference` and
  :func:`shadow_walk_batched_reference`: the same, for every active member
  of a stacked ``[B, J]`` table, one member at a time.
- :func:`queue_select_batched_reference`: :func:`queue_select_reference`
  for requested rows of a stacked ``[B, T]`` score matrix and mask.
"""

from __future__ import annotations

import torch

BIG = 2**30 - 1
WAITING, RUNNING = 1, 2     # repro_torch.core.jobs' job states

# Key modes of the fused selection.  Each builds (key, mask) per row:
HEAD_SUBMIT = 0        # (submit, WAITING): the FCFS head, backfill's head
HEAD_ESTIMATE = 1      # (estimate, WAITING): the SJF head
HEAD_NEG_ESTIMATE = 2  # (-estimate, WAITING): the LJF head
BESTFIT = 3            # (free - nodes, WAITING & nodes <= cap)
ANY_FIT = 4            # (0, WAITING & nodes <= cap & row != exclude)
BACKFILL_CAND = 5      # (submit, WAITING & nodes <= cap & row != exclude
                       #  & (clock + estimate <= shadow
                       #     | nodes <= min(free, extra)))
PREEMPT_TIER = 6       # (where(WAITING, priority, BIG), every row)
PREEMPT_HEAD = 7       # (submit, WAITING & priority == tier)
# the scalars of a request, in the order of the kernel's SelectArgs
PARAMS = ("clock", "free", "cap", "shadow", "extra", "exclude", "tier",
          "head_need")


def params(clock: int = 0, free: int = 0, cap: int = 0, shadow: int = 0,
           extra: int = 0, exclude: int = -1, tier: int = 0,
           head_need: int = 0) -> tuple:
    """A request's scalars as a tuple in :data:`PARAMS` order."""
    return (clock, free, cap, shadow, extra, exclude, tier, head_need)

MODES = {"head_submit": HEAD_SUBMIT, "head_estimate": HEAD_ESTIMATE,
         "head_neg_estimate": HEAD_NEG_ESTIMATE, "bestfit": BESTFIT,
         "any_fit": ANY_FIT, "backfill_cand": BACKFILL_CAND,
         "preempt_tier": PREEMPT_TIER, "preempt_head": PREEMPT_HEAD}


def queue_select_reference(scores: torch.Tensor,
                           feasible: torch.Tensor) -> torch.Tensor:
    """i32[2] = (first index attaining the minimum feasible score, that
    score), or ``(-1, BIG)`` when nothing is feasible.

    Two-stage min (the value, then the lowest index attaining it), so the
    answer never depends on which index ``torch.argmin`` returns on ties.
    A feasible entry scoring ``BIG`` or more is still found.
    """
    feas = feasible.to(torch.bool)
    rows = torch.arange(scores.shape[0], dtype=torch.int32,
                        device=scores.device)
    best = torch.min(torch.where(feas, scores, torch.iinfo(torch.int32).max))
    idx = torch.min(torch.where(feas & (scores == best), rows, BIG))
    found = torch.any(feas)
    return torch.stack([torch.where(found, idx, -1),
                        torch.where(found, best, BIG)]).to(torch.int32)


def queue_select_batched_reference(scores: torch.Tensor,
                                   feasible: torch.Tensor,
                                   members) -> list:
    """``(index, score)`` as Python ints for each requested row ``b`` of
    ``members`` of the ``[B, T]`` scores and mask: what
    :func:`queue_select_reference` gives on ``scores[b]`` and
    ``feasible[b]`` (the first index of the least feasible score, or ``(-1,
    BIG)``), for every row at once."""
    rows_b = torch.as_tensor(list(members), dtype=torch.long,
                             device=scores.device)
    sc = scores[rows_b]
    feas = feasible[rows_b].to(torch.bool)
    rows = torch.arange(scores.shape[-1], dtype=torch.int32,
                        device=scores.device)
    best = torch.min(torch.where(feas, sc, torch.iinfo(torch.int32).max),
                     dim=-1).values
    idx = torch.min(torch.where(feas & (sc == best[:, None]), rows, BIG),
                    dim=-1).values
    found = torch.any(feas, dim=-1)
    return [tuple(p) for p in torch.stack(
        [torch.where(found, idx, -1), torch.where(found, best, BIG)],
        dim=-1).tolist()]


def fused_key_mask(mode: int, cols: dict, jstate: torch.Tensor, clock: int,
                   free: int, cap: int, shadow: int, extra: int,
                   exclude: int, tier: int):
    """(key i32[J], mask bool[J]) of ``mode`` over the job-table columns
    ``cols`` (``submit``, ``estimate``, ``nodes``, ``priority``) and the
    job states.  Sums wrap in int32, as the kernel's do."""
    waiting = jstate == WAITING
    rows = torch.arange(jstate.shape[0], device=jstate.device)
    nodes = cols["nodes"]
    if mode == HEAD_SUBMIT:
        return cols["submit"], waiting
    if mode == HEAD_ESTIMATE:
        return cols["estimate"], waiting
    if mode == HEAD_NEG_ESTIMATE:
        return -cols["estimate"], waiting
    if mode == BESTFIT:
        return free - nodes, waiting & (nodes <= cap)
    if mode == ANY_FIT:
        return (torch.zeros_like(nodes),
                waiting & (nodes <= cap) & (rows != exclude))
    if mode == BACKFILL_CAND:
        ends_by = (cols["estimate"] + clock) <= shadow
        within = nodes <= min(free, extra)
        return cols["submit"], (waiting & (nodes <= cap) & (rows != exclude)
                                & (ends_by | within))
    if mode == PREEMPT_TIER:
        return (torch.where(waiting, cols["priority"], BIG).to(torch.int32),
                torch.ones_like(waiting))
    if mode == PREEMPT_HEAD:
        return cols["submit"], waiting & (cols["priority"] == tier)
    raise ValueError(f"unknown fused-select mode {mode}")


def fused_select_reference(mode: int, cols: dict, jstate: torch.Tensor,
                           clock: int = 0, free: int = 0, cap: int = 0,
                           shadow: int = 0, extra: int = 0, exclude: int = -1,
                           tier: int = 0) -> tuple[int, int]:
    """``(index, score)`` of the masked lexicographic argmin of ``mode``'s
    key and mask (see :func:`fused_key_mask`), as Python ints."""
    key, mask = fused_key_mask(mode, cols, jstate, clock, free, cap, shadow,
                               extra, exclude, tier)
    idx, score = queue_select_reference(key, mask).tolist()
    return idx, score


def shadow_walk_reference(nodes: torch.Tensor, jstate: torch.Tensor,
                          rsv_finish: torch.Tensor, clock: int, free: int,
                          head_need: int) -> tuple[int, int, int]:
    """EASY shadow reservation ``(shadow, extra, k_row)`` for a head that
    needs ``head_need`` nodes.

    The running jobs' releases ``(max(rsv_finish, clock + 1), row)`` are
    taken in lexicographic order (a stable sort on the clamped time), and
    their nodes added to ``free`` until the sum covers the head.  Coverage
    is tested only after a release is added, so at least one is always
    counted.  ``shadow`` is the covering release's time, ``extra`` the
    spare nodes then, ``k_row`` its row; ``(BIG, free, -1)`` when the
    whole running set cannot cover the head.
    """
    running = jstate == RUNNING
    rows = torch.nonzero(running).flatten()
    t = torch.clamp(rsv_finish[rows], min=clock + 1)
    order = torch.sort(t, stable=True)[1]
    rows, t = rows[order], t[order]
    cum = free + torch.cumsum(nodes[rows], 0, dtype=torch.int32)
    covered = torch.nonzero(cum >= head_need).flatten()
    if covered.numel() == 0:
        return BIG, free, -1
    p = int(covered[0])
    return int(t[p]), int(cum[p]) - head_need, int(rows[p])


def fused_select_batched_reference(modes, cols_b: dict, jstate_b: torch.Tensor,
                                   params_b, active) -> list:
    """One fused selection for every active member of a stacked table.

    ``cols_b`` maps the table's columns to ``[B, J]`` tensors and
    ``jstate_b`` is ``[B, J]``; ``modes``, ``params_b`` (dicts of
    :data:`PARAMS` scalars other than ``head_need``) and ``active`` have one
    entry a member.  Returns B entries: member ``b``'s ``(index, score)``
    from :func:`fused_select_reference` over its own rows, or ``None`` where
    ``b`` is idle.  Indices are member-local."""
    return [fused_select_reference(modes[b], {c: t[b] for c, t in
                                              cols_b.items()},
                                   jstate_b[b], **params_b[b])
            if active[b] else None for b in range(jstate_b.shape[0])]


def shadow_walk_batched_reference(nodes_b: torch.Tensor,
                                  jstate_b: torch.Tensor,
                                  rsv_finish_b: torch.Tensor, params_b,
                                  active) -> list:
    """The EASY shadow walk for every active member of a stacked table:
    B entries, member ``b``'s ``(shadow, extra, k_row)`` from
    :func:`shadow_walk_reference` with ``params_b[b]``'s ``clock``, ``free``
    and ``head_need``, or ``None`` where ``b`` is idle."""
    return [shadow_walk_reference(nodes_b[b], jstate_b[b], rsv_finish_b[b],
                                  params_b[b]["clock"], params_b[b]["free"],
                                  params_b[b]["head_need"])
            if active[b] else None for b in range(jstate_b.shape[0])]
