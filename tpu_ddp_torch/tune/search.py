"""The search strategy: coordinate descent + successive-halving (the
port's copy of tpu_ddp/tune/search.py, the same behaviour).

The knob space is small (a handful of knobs, 2-4 candidates each) but a
trial costs real wall time, so the search spends cheap short-window
trials ruling cells out and expensive long-window (median-of-3) trials
only on finalists — successive halving with two rungs:

- **explore** (short fidelity): full grid when the live space has <= 2
  knobs (it is exhaustively affordable: at most ~12 cells); coordinate
  descent otherwise — sweep one knob at a time holding the incumbent
  fixed, adopt a move only when it beats the incumbent by ``epsilon``
  (measurement noise must not walk the search), repeat passes until a
  full pass makes no move;
- **confirm** (long fidelity): the top ``promote_top`` short-window
  assignments AND the pure-default assignment re-measure with
  median-of-3 windows; the confirmed winner takes it.

Every (assignment, fidelity) cell is memoized — a quarantined cell is
remembered as infeasible and never re-attempted. The final regression
guard compares winner-vs-default at the SAME (long) fidelity and
returns empty overrides unless the winner actually wins: the tuner may
be useless, but it must never ship a slowdown (acceptance: tuned >=
default, equal acceptable).
"""

from __future__ import annotations

__all__ = ["run_search"]

MAX_PASSES = 3


def run_search(knobs, evaluate, base: dict, *, epsilon: float = 0.02,
               promote_top: int = 2, log=None) -> dict:
    """Search ``knobs`` (``searchable_knobs`` output: list of
    ``(knob, candidates)`` with the config's current value first) using
    ``evaluate(assignment, fidelity) -> (steps_per_sec | None, reason)``
    (``TrialRunner.evaluate`` or a test double). ``base`` maps every
    searched field to its current/default value.

    Returns ``{"overrides", "default_steps_per_sec",
    "tuned_steps_per_sec", "trials", "quarantined", "mode", "history"}``
    — ``overrides`` holds only the fields whose winning value differs
    from ``base`` (empty == keep the defaults).
    """
    log = log or (lambda s: None)
    memo: dict = {}
    history: list = []
    counts = {"trials": 0, "quarantined": 0}

    def measure(assignment: dict, fidelity: str) -> float | None:
        key = (tuple(sorted(assignment.items())), fidelity)
        if key in memo:
            return memo[key]
        sps, reason = evaluate(assignment, fidelity)
        if sps is not None or (reason or "").startswith("quarantined"):
            counts["trials"] += 1
        if (reason or "").startswith("quarantined"):
            counts["quarantined"] += 1
        memo[key] = sps
        history.append({"assignment": dict(assignment),
                        "fidelity": fidelity,
                        "steps_per_sec": (round(sps, 3)
                                          if sps is not None else None),
                        "reason": reason})
        return sps

    default_assign = {knob.field: cands[0] for knob, cands in knobs}
    if not knobs:
        return {"overrides": {}, "default_steps_per_sec": None,
                "tuned_steps_per_sec": None, "trials": 0,
                "quarantined": 0, "mode": "empty", "history": []}

    # -- explore rung (short fidelity) --------------------------------
    if len(knobs) <= 2:
        mode = "grid"
        cells = [{}]
        for knob, cands in knobs:
            cells = [{**cell, knob.field: v}
                     for cell in cells for v in cands]
        for cell in cells:
            measure(cell, "short")
    else:
        mode = "coordinate_descent"
        incumbent = dict(default_assign)
        incumbent_sps = measure(incumbent, "short")
        for _ in range(MAX_PASSES):
            moved = False
            for knob, cands in knobs:
                for v in cands:
                    if v == incumbent[knob.field]:
                        continue
                    sps = measure({**incumbent, knob.field: v}, "short")
                    if sps is not None and (
                            incumbent_sps is None
                            or sps > incumbent_sps * (1 + epsilon)):
                        incumbent = {**incumbent, knob.field: v}
                        incumbent_sps = sps
                        moved = True
            if not moved:
                break

    # -- confirm rung (long fidelity, successive-halving promotion) ---
    shorts = [(h["steps_per_sec"], h["assignment"]) for h in history
              if h["fidelity"] == "short"
              and h["steps_per_sec"] is not None]
    shorts.sort(key=lambda t: -t[0])
    finalists: list[dict] = []
    for _, assignment in shorts:
        if assignment not in finalists:
            finalists.append(assignment)
        if len(finalists) >= promote_top:
            break
    if default_assign not in finalists:
        finalists.append(default_assign)

    default_sps = None
    best_assign, best_sps = default_assign, None
    for assignment in finalists:
        sps = measure(assignment, "long")
        if assignment == default_assign:
            default_sps = sps
        if sps is not None and (best_sps is None or sps > best_sps):
            best_assign, best_sps = assignment, sps

    # -- regression guard ---------------------------------------------
    overrides = {f: v for f, v in best_assign.items() if v != base.get(f)}
    if overrides and default_sps is not None and best_sps is not None \
            and best_sps <= default_sps:
        log("[autotune] winner did not beat defaults at confirm "
            f"fidelity ({best_sps:.2f} vs {default_sps:.2f} steps/s); "
            "keeping defaults")
        overrides, best_sps = {}, default_sps
    if not overrides and default_sps is not None:
        best_sps = default_sps

    return {"overrides": overrides,
            "default_steps_per_sec": (round(default_sps, 3)
                                      if default_sps else None),
            "tuned_steps_per_sec": (round(best_sps, 3)
                                    if best_sps else None),
            "trials": counts["trials"],
            "quarantined": counts["quarantined"],
            "mode": mode, "history": history}
