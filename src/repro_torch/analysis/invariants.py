"""Invariant auditor of the paged serving stack (the port's copy of
``repro.analysis.invariants``; numpy only).

The device page table, the host stash, the freeze metadata and the
staging slots describe the same pages from different sides.  A fault
path that leaves them disagreeing (a page both resident and
timer-tracked, a staged key whose page is gone, stash-byte accounting
that drifts from the stored arrays) corrupts generation long after the
step that caused it.  ``audit_controller`` and ``audit_boundary`` check
that they agree at the one moment the host holds a coherent view, the
page-boundary tick right after the controller pass, and raise
``InvariantViolation`` naming the first inconsistency.

Cost: numpy scans of host metadata (no device copy), linear in pool
slots and stash entries.  The paged engine runs them only under
``debug_invariants`` (tests and chaos runs); a serving tick skips them.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


class InvariantViolation(AssertionError):
    """A pool/stash/lane consistency invariant does not hold."""


def _fail(msg: str) -> None:
    raise InvariantViolation(msg)


def audit_controller(ctl) -> None:
    """Invariants of a ``PagedController`` alone:

    * the stash-byte gauge equals the bytes recomputed from the store;
    * every timer-tracked page (``frozen_meta``) has its bytes in the
      store, and a positive timer (an expired timer is consumed by the
      tick that expired it);
    * every staged key is a stashed page in a slot its lane reserved;
    * the byte gauges are non-negative.
    """
    recomputed = ctl.host_bytes()
    if ctl.stash_bytes != recomputed:
        _fail(f"stash_bytes gauge {ctl.stash_bytes} != "
              f"recomputed store bytes {recomputed}")
    if ctl.stash_bytes < 0 or ctl.exported_bytes < 0:
        _fail(f"negative byte gauge: stash={ctl.stash_bytes} "
              f"exported={ctl.exported_bytes}")
    for key in ctl.frozen_meta:
        if key not in ctl.store:
            _fail(f"frozen_meta key {key} has no stored bytes")
        if ctl.frozen_meta[key]["d"] <= 0:
            _fail(f"frozen_meta key {key} carries non-positive timer "
                  f"{ctl.frozen_meta[key]['d']}")
    for key, slot in ctl.staged_keys.items():
        if key not in ctl.frozen_meta:
            _fail(f"staged key {key} is not a stashed page")
        reserved = ctl.stage_slots.get((key[0], key[1]), [])
        if slot not in reserved:
            _fail(f"staged key {key} sits in slot {slot}, not one of the "
                  f"lane's reserved staging slots {reserved}")


def audit_boundary(ctl, pool: Dict[str, np.ndarray],
                   fstate: Dict[str, np.ndarray],
                   lanes: Iterable[int],
                   lane_ids: Dict[int, int] | None = None) -> None:
    """``audit_controller``, then the pool against the stash over the
    boundary tick's host copies.

    ``pool``/``fstate`` are the numpy slices the controller pass just ran
    on; ``lanes`` are their batch indices, ``lane_ids`` maps them to the
    engine's lanes (identity when None).

    * no global page id occupies two physical slots of one (layer, lane);
    * ``slot_mask`` asserts no token in an unmapped slot, and no frozen
      flag sits on one;
    * no page is both device-mapped and timer-tracked in the host stash
      for the same (layer, lane): a swap-in would overwrite a live slot.
    """
    audit_controller(ctl)
    pt, sm = pool["page_table"], pool["slot_mask"]
    frozen = fstate["frozen"]
    L = pt.shape[0]
    for b in lanes:
        gb = lane_ids[b] if lane_ids is not None else b
        for l in range(L):
            gids = pt[l, b][pt[l, b] >= 0]
            if len(gids) != len(np.unique(gids)):
                _fail(f"layer {l} lane {gb}: page table maps a global id "
                      f"into two slots: {sorted(gids.tolist())}")
            unmapped = pt[l, b] < 0
            if bool(np.any(sm[l, b][unmapped])):
                _fail(f"layer {l} lane {gb}: slot_mask asserts tokens in "
                      f"an unmapped physical slot")
            if bool(np.any(frozen[l, b] & unmapped)):
                _fail(f"layer {l} lane {gb}: frozen flag on an unmapped "
                      f"physical slot")
            resident = set(int(g) for g in gids)
            stashed = {key[2] for key in ctl.frozen_meta
                       if key[0] == l and key[1] == gb}
            both = resident & stashed
            if both:
                _fail(f"layer {l} lane {gb}: pages {sorted(both)} are "
                      f"both device-resident and stash-timer-tracked")
