"""Time loops that the multi-device dry-run stands in for.

A recurrence over time runs the same work at every step: the sLSTM's
steps, the plain versions of the mLSTM and SSM scans (their steps, or
their chunks), and ``common.time_chunks``' recomputed chunks each run
the same ops on tensors of the same shapes from one step to the next.
The dry-run (``launch/dryrun.py``) runs a step on fake tensors, which
carry no values, and dispatches every op of it in Python: the sLSTM's
32768 steps of 17 ops in each of xlstm-350m's 12 pair blocks alone would
take hours. So inside ``stand_in_time_loops()``, which the dry-run enters
and which refuses to run outside a ``FakeTensorMode``:

- ``steps(n)`` yields the first and the last of n steps only. Where a
  loop writes each step's output into a tensor made before it (the
  scans), a step left out changes nothing the memory tracker sees: every
  step frees what it makes but the carry it hands on, which has the
  same shapes at every step. Where a loop keeps each step's output (the
  sLSTM's list), ``kept_outputs`` makes the outputs of the steps left
  out as one block of the same bytes;
- without autograd (a prefill or decode step) every loop is cut so;
- under autograd (a train step) ``common.time_chunks`` runs its last
  chunk but one in full and cuts the loops inside every other chunk.
  Each chunk still keeps what a full one keeps (its output, the carry
  its recomputation starts from) and issues the same collectives; only
  its recomputed activations in the backward are fewer. The backward
  runs the chunks from the last: the last one's before any gradient of
  the sequence is summed, the last but one's beside the sums and with
  the most carries still kept, so that chunk's recomputation is the
  loop's peak, and it runs in full.

``tests/test_torch_dryrun.py`` holds records made so to those of the
full loops at a size where those finish: peak, temp and output bytes,
and collective bytes and counts by kind. Outside the context every loop
runs every step.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

_ALLOWED = False      # inside stand_in_time_loops()
_ACTIVE = False       # the loops running now are cut


@contextlib.contextmanager
def stand_in_time_loops():
    """Let the time loops run inside the ``with`` stand in for their
    middle steps (see the module docstring). For fake tensors only."""
    global _ALLOWED
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("stand_in_time_loops: the loops' values would "
                           "be wrong; enter it under a FakeTensorMode")
    old, _ALLOWED = _ALLOWED, True
    try:
        yield
    finally:
        _ALLOWED = old


def run_cut(cut: bool, fn, *args):
    """``fn(*args)`` with its loops cut if ``cut`` (and allowed)."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, cut and _ALLOWED
    try:
        return fn(*args)
    finally:
        _ACTIVE = old


def steps(n: int):
    """``range(n)``, or its first and last step where loops are cut."""
    if _ACTIVE and n > 2:
        return (0, n - 1)
    return range(n)


def kept_outputs(out: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Stand-ins, shaped as ``out``, for the outputs of the steps that
    ``steps(n)`` leaves out (none unless loops are cut): views of one
    block, so that they take the bytes that the steps' own would."""
    if not (_ACTIVE and n > 2):
        return []
    return list(out.new_empty((n - 2,) + tuple(out.shape)).unbind(0))
