"""Poisson-arrival load generator and latency/goodput measurement — the
port of tpu_ddp/serve/loadgen.py (pure host code: numpy and the engine's
drive surface).

The serving question is what latency distribution users see at a given
request rate, so the benchmark models an open system: requests arrive by
a seeded Poisson process (exponential gaps at ``rate`` req/s), are
submitted the moment their arrival time passes, and the engine steps
continuously in between. :func:`run_load` reports TTFT, end-to-end and
inter-token (TPOT, from the engine's per-token stamps) percentiles,
tokens/s over the makespan, and goodput — tokens of requests whose TTFT
met ``slo_ttft_ms`` — with the accounting identity completed + cancelled
+ shed == submitted. :func:`calibrate_rate` measures saturation
throughput so rates can be fractions of capacity.

:func:`make_trace` builds a day-in-the-life trace (a seeded
non-homogeneous Poisson process: a diurnal sinusoid, flash-crowd windows,
a tenant mix) and :func:`run_trace` replays it on a virtual clock with
per-tenant breakdowns. Workloads, arrivals and traces are pure functions
of their seeds and equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One workload item (engine-independent, so the same workload
    drives the continuous engine and the static baseline)."""

    prompt: tuple
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    tenant: str = "default"


def make_workload(n: int, vocab_size: int, seed: int = 0,
                  prompt_len: tuple[int, int] = (4, 17),
                  max_new: tuple[int, int] = (4, 17),
                  temperature: float = 0.0) -> list[RequestSpec]:
    """``n`` seeded requests with uniformly varied prompt lengths and
    generation budgets (half-open ranges). Varied ``max_new`` is what
    separates the schedulers: under static batching the whole batch
    waits for its slowest member."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        p_len = int(rng.integers(*prompt_len))
        prompt = tuple(int(t) for t in
                       rng.integers(0, vocab_size, size=p_len))
        specs.append(RequestSpec(
            prompt=prompt,
            max_new_tokens=int(rng.integers(*max_new)),
            temperature=temperature, seed=i))
    return specs


def make_shared_prefix_workload(n: int, vocab_size: int, seed: int = 0,
                                prefix_len: int = 16,
                                tail_len: tuple[int, int] = (2, 9),
                                max_new: tuple[int, int] = (4, 9),
                                temperature: float = 0.0
                                ) -> list[RequestSpec]:
    """``n`` seeded requests sharing one ``prefix_len``-token system
    prompt, each with a distinct random tail — the workload prefix
    caching exists for: an uncached engine prefills the shared prefix
    ``n`` times, a cached one once (plus tails)."""
    rng = np.random.default_rng(seed)
    system = tuple(int(t) for t in
                   rng.integers(0, vocab_size, size=prefix_len))
    specs = []
    for i in range(n):
        t_len = int(rng.integers(*tail_len))
        tail = tuple(int(t) for t in
                     rng.integers(0, vocab_size, size=t_len))
        specs.append(RequestSpec(
            prompt=system + tail,
            max_new_tokens=int(rng.integers(*max_new)),
            temperature=temperature, seed=i))
    return specs


def make_long_prompt_workload(n: int, vocab_size: int, seed: int = 0,
                              prompt_len: int = 1024,
                              max_new: tuple[int, int] = (4, 9),
                              temperature: float = 0.0
                              ) -> list[RequestSpec]:
    """``n`` seeded requests all carrying one FIXED ``prompt_len`` —
    the long-context axis. Where :func:`make_workload`
    varies prompt length to stress the scheduler, this holds it
    constant and lets a sweep vary it ACROSS cells: prompt length,
    not arrival rate, is the independent variable."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        prompt = tuple(int(t) for t in
                       rng.integers(0, vocab_size, size=prompt_len))
        specs.append(RequestSpec(
            prompt=prompt,
            max_new_tokens=int(rng.integers(*max_new)),
            temperature=temperature, seed=i))
    return specs


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds from run start) at ``rate``
    requests/second."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def assert_atomic_cutover(requests) -> None:
    """Pin the weight-streaming cutover contract
    over finished requests: every token carries exactly one param
    version stamp, and stamps never decrease within a request — a
    request may SPAN versions (token t on N, token t+1 on N+1) but no
    token is ever produced by a mixed forward, and an engine never
    steps backwards through versions mid-request."""
    for req in requests:
        vers = getattr(req, "token_versions", None)
        if vers is None:
            continue
        if len(vers) != len(req.tokens):
            raise AssertionError(
                f"request {getattr(req, 'rid', '?')}: "
                f"{len(req.tokens)} tokens but {len(vers)} version "
                "stamps — a token sampled without a version")
        for a, b in zip(vers, vers[1:]):
            if b < a:
                raise AssertionError(
                    f"request {getattr(req, 'rid', '?')}: param "
                    f"version went backwards ({a} -> {b}) mid-request")


def run_load(engine, specs: list[RequestSpec], rate: float,
             seed: int = 0, slo_ttft_ms: float | None = None) -> dict:
    """Drive ``engine`` with ``specs`` arriving Poisson at ``rate``;
    block until every request completes; return the metrics dict."""
    arrivals = poisson_arrivals(len(specs), rate, seed)
    handles: list = [None] * len(specs)
    t0 = time.perf_counter()
    nxt = 0
    while True:
        now = time.perf_counter() - t0
        while nxt < len(specs) and arrivals[nxt] <= now:
            sp = specs[nxt]
            handles[nxt] = engine.submit(
                sp.prompt, sp.max_new_tokens,
                temperature=sp.temperature, seed=sp.seed,
                tenant=sp.tenant)
            nxt += 1
        worked = engine.step()
        if not worked:
            if nxt >= len(specs):
                break  # idle and nothing left to arrive: all done
            # Idle but ahead of the arrival process: sleep to the next
            # arrival instead of spinning.
            time.sleep(max(0.0, min(
                arrivals[nxt] - (time.perf_counter() - t0), 0.05)))
    t_end = time.perf_counter()

    # Honest accounting under load shedding and failover: latency
    # percentiles are over COMPLETED requests only (a shed request has
    # no TTFT to measure — it shows up in slo_attained and the
    # completed/shed/cancelled partition instead). Nothing is lost:
    # completed + cancelled + shed == submitted in every run, and the
    # chaos drills pin that identity.
    completed = [h for h in handles
                 if not h.cancelled and not getattr(h, "shed", False)]
    n_shed = sum(bool(getattr(h, "shed", False)) for h in handles)
    n_cancelled = sum(h.cancelled and not getattr(h, "shed", False)
                      for h in handles)
    n_quarantined = sum(bool(getattr(h, "quarantined", False))
                        for h in handles)
    n_migrations = sum(getattr(h, "migrations", 0) for h in handles)

    ttfts = np.array([h.ttft_s for h in completed
                      if h.ttft_s is not None]) * 1e3     # ms
    n_tokens = np.array([len(h.tokens) for h in completed], dtype=int)
    e2es = np.array([h.finished_at - h.submitted_at
                     for h in completed]) * 1e3            # ms
    # Inter-token gaps pooled across completed requests, from the
    # per-token emission stamps the engine records — NOT the old
    # (finished - first) / (n - 1) per-request average, which
    # silently assumed one token per engine step: under speculative
    # decoding (serve/speculative.py) a step emits a BURST of tokens,
    # and the uniform estimate averaged the bursts away while the
    # p99 story lives in the inter-burst gaps the stamps expose.
    # Requests without stamps (a handle built outside the engine)
    # fall back to uniform synthetic gaps so they still weigh in.
    def _req_gaps(h):
        stamps = getattr(h, "token_times", None)
        if stamps and len(stamps) == len(h.tokens):
            return np.diff(stamps)
        n = len(h.tokens) - 1
        return np.full(n, (h.finished_at - h.first_token_at) / n)

    tpots = (np.concatenate(
        [_req_gaps(h) for h in completed if len(h.tokens) > 1])
        if any(len(h.tokens) > 1 for h in completed)
        else np.array([])) * 1e3
    makespan = t_end - t0
    # Weight-streaming provenance: each completed
    # request reports the param version(s) its tokens sampled under,
    # and the atomic-cutover contract is asserted on every run — a
    # live-published run that violated it would fail its benchmark.
    assert_atomic_cutover(completed)
    all_vers = [v for h in completed
                for v in getattr(h, "token_versions", ())]
    n_spanning = sum(
        1 for h in completed
        if len(set(getattr(h, "token_versions", ()))) > 1)
    if slo_ttft_ms is None:
        good = n_tokens.sum() if n_tokens.size else 0
        attained = None
    else:
        good = n_tokens[ttfts <= slo_ttft_ms].sum() \
            if n_tokens.size else 0
        # Attainment is over SUBMITTED requests: a shed or failed
        # request missed its SLO by definition.
        attained = round(float((ttfts <= slo_ttft_ms).sum())
                         / len(specs), 4) if len(specs) else None
    pct = lambda a, q: (round(float(np.percentile(a, q)), 3)  # noqa: E731
                        if a.size else None)
    return {
        "rate_rps": rate,
        "n_requests": len(specs),
        "n_completed": len(completed),
        "n_shed": int(n_shed),
        "n_cancelled": int(n_cancelled),
        "n_quarantined": int(n_quarantined),
        "n_migrations": int(n_migrations),
        "accounting_ok": (len(completed) + n_cancelled + n_shed
                          == len(specs)),
        "total_tokens": int(n_tokens.sum()) if n_tokens.size else 0,
        "makespan_s": round(makespan, 4),
        "ttft_p50_ms": pct(ttfts, 50),
        "ttft_p99_ms": pct(ttfts, 99),
        "ttft_mean_ms": (round(float(ttfts.mean()), 3)
                         if ttfts.size else None),
        "e2e_p50_ms": pct(e2es, 50),
        "e2e_p99_ms": pct(e2es, 99),
        "tpot_p50_ms": pct(tpots, 50),
        "tpot_p99_ms": pct(tpots, 99),
        "tpot_mean_ms": (round(float(tpots.mean()), 3)
                         if tpots.size else None),
        "tokens_per_sec": round(float(n_tokens.sum() if n_tokens.size
                                      else 0) / makespan, 3),
        "slo_ttft_ms": slo_ttft_ms,
        "slo_attained": attained,
        "param_version_min": (int(min(all_vers)) if all_vers else None),
        "param_version_max": (int(max(all_vers)) if all_vers else None),
        "n_version_spanning": int(n_spanning),
        "goodput_tokens_per_sec": round(float(good) / makespan, 3),
    }


def calibrate_rate(engine_factory, specs: list[RequestSpec]) -> float:
    """Measure this host's saturation throughput (requests/sec with
    every request available at t=0) so sweep rates can be FRACTIONS of
    capacity rather than absolute numbers — the same sweep script then
    exercises under/at/over-saturation regimes on any host."""
    engine = engine_factory()
    t0 = time.perf_counter()
    for sp in specs:
        engine.submit(sp.prompt, sp.max_new_tokens,
                      temperature=sp.temperature, seed=sp.seed,
                      tenant=sp.tenant)
    engine.run()
    elapsed = time.perf_counter() - t0
    return len(specs) / elapsed


# ---------------------------------------------------------------------------
# Day-in-the-life traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One scheduled arrival: WHEN (seconds from trace start, scaled
    by ``run_trace(time_scale=...)`` at replay) and WHAT."""

    at_s: float
    spec: RequestSpec


def diurnal_rate(t: float, duration_s: float, base_rate: float,
                 peak_rate: float,
                 flash_crowds: tuple = ()) -> float:
    """Instantaneous arrival rate at time ``t``: one sinusoidal
    diurnal cycle (trough at the endpoints, peak mid-trace) times any
    flash-crowd window multiplier covering ``t``. Exposed so tests can
    pin the thinning envelope."""
    frac = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / duration_s))
    rate = base_rate + (peak_rate - base_rate) * frac
    for start, end, mult in flash_crowds:
        if start <= t < end:
            rate *= mult
    return float(rate)


def make_trace(duration_s: float, base_rate: float, peak_rate: float,
               vocab_size: int, seed: int = 0,
               tenant_mix: dict[str, float] | None = None,
               flash_crowds: tuple = (),
               shared_prefix_len: int = 0,
               prompt_len: tuple[int, int] = (4, 17),
               max_new: tuple[int, int] = (4, 17),
               temperature: float = 0.0) -> list[TraceEvent]:
    """A seeded day-in-the-life arrival trace.

    Arrivals follow a non-homogeneous Poisson process — candidate
    points at the envelope rate, thinned by accept-probability
    ``rate(t) / rate_max`` (the standard Lewis–Shedler construction,
    exact and fully seeded). The rate curve is :func:`diurnal_rate`:
    a ``base_rate``→``peak_rate`` sinusoid over ``duration_s``, with
    ``flash_crowds`` = ``((start_s, end_s, multiplier), ...)`` windows
    stacked on top — the burst shape autoscaling hysteresis exists to
    absorb without thrash.

    ``tenant_mix`` maps tenant name → relative traffic share (need not
    sum to 1). With ``shared_prefix_len > 0`` each tenant gets its OWN
    seeded system prompt of that length: identical structure across
    tenants but disjoint token streams, so prefix-namespace isolation
    is exercised by construction (a cross-tenant hit would be visible
    as a hit on a prefix that tenant never submitted).
    """
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if not 0 < base_rate <= peak_rate:
        raise ValueError(
            f"need 0 < base_rate <= peak_rate, got "
            f"{base_rate}/{peak_rate}")
    for fc in flash_crowds:
        if len(fc) != 3 or not (0 <= fc[0] < fc[1]) or fc[2] <= 0:
            raise ValueError(f"flash crowd {fc!r}: expected "
                             "(start_s, end_s, multiplier > 0)")
    mix = dict(tenant_mix) if tenant_mix else {"default": 1.0}
    total = sum(mix.values())
    if total <= 0 or any(w < 0 for w in mix.values()):
        raise ValueError(f"tenant_mix weights must be >= 0 with a "
                         f"positive sum, got {mix}")
    names = sorted(mix)
    probs = np.array([mix[n] / total for n in names])
    rng = np.random.default_rng(seed)
    # Per-tenant system prompts: seeded off the same generator, drawn
    # in sorted-name order so the trace is a pure function of its
    # arguments.
    prefixes = {n: tuple(int(t) for t in
                         rng.integers(0, vocab_size,
                                      size=shared_prefix_len))
                for n in names} if shared_prefix_len else {}
    rate_max = max(diurnal_rate(t, duration_s, base_rate, peak_rate,
                                flash_crowds)
                   for t in np.linspace(0.0, duration_s, 512))
    events: list[TraceEvent] = []
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_s:
            break
        if rng.random() * rate_max > diurnal_rate(
                t, duration_s, base_rate, peak_rate, flash_crowds):
            continue   # thinned: candidate above the true rate curve
        tenant = names[int(rng.choice(len(names), p=probs))]
        p_len = int(rng.integers(*prompt_len))
        tail = tuple(int(tok) for tok in
                     rng.integers(0, vocab_size, size=p_len))
        events.append(TraceEvent(at_s=round(t, 6), spec=RequestSpec(
            prompt=prefixes.get(tenant, ()) + tail,
            max_new_tokens=int(rng.integers(*max_new)),
            temperature=temperature, seed=i, tenant=tenant)))
        i += 1
    return events


class _VirtualClock:
    """The fleet-parallel trace clock :func:`run_trace` advances —
    callable (seconds) so it can stand in for ``time.monotonic`` as an
    Autoscaler's control-plane clock."""

    __slots__ = ("t",)

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _slo_inversions(records: list[dict], weights: dict[str, int],
                    slo_ttft_ms: float) -> int:
    """Cross-tenant SLO inversions: a shed request whose class
    OUTWEIGHS that of some strictly-lower-class request that arrived
    no earlier and still completed within the TTFT SLO. Weighted fair
    queueing plus lowest-class-first shedding makes this structurally
    zero; the count is the acceptance check that says so."""
    shed = [r for r in records if r["shed"]]
    ok = [r for r in records
          if not r["cancelled"] and not r["shed"]
          and r["ttft_ms"] is not None and r["ttft_ms"] <= slo_ttft_ms]
    n = 0
    for s in shed:
        ws = weights.get(s["tenant"], 1)
        n += sum(1 for r in ok
                 if weights.get(r["tenant"], 1) < ws
                 and r["at_s"] >= s["at_s"])
    return n


def run_trace(engine, trace: list[TraceEvent], seed: int = 0,
              slo_ttft_ms: float | None = None,
              time_scale: float = 1.0,
              class_weights: dict[str, int] | None = None) -> dict:
    """Replay a :func:`make_trace` trace against ``engine`` (one
    engine, a Router, or an Autoscaler — anything with the drive
    surface) and report fleet-wide AND per-tenant metrics.

    **Time is virtual and fleet-parallel.** The test host steps a
    fleet's replicas sequentially in one process, so wall-clock
    throughput cannot scale with replica count — a 3-replica fleet
    measured on wall time looks exactly as fast as 1. A real fleet
    runs one replica per host, so the harness charges each drive
    round ``wall_cost / (time_scale * live_capacity)`` of trace time:
    the time the round would take on parallel hardware. Arrivals,
    TTFT, SLO attainment, makespan and replica-seconds are all read
    off this virtual clock (idle lulls between arrivals fast-forward
    instead of sleeping), which is what makes goodput-per-replica-
    second comparable across fleet sizes on one machine — the same
    move as the fleet sweep's equal-simulated-hardware cells. An
    Autoscaler's ``set_clock`` is hooked up automatically so its
    cooldown windows and replica-second integral tick in trace time.

    ``time_scale`` sets how expensive one replica-second of compute
    is in trace seconds: at ``time_scale=1.0`` (the calibrated-sweep
    setting) one wall second of single-replica stepping is one trace
    second, so :func:`calibrate_rate`'s requests/sec plugs straight
    into ``make_trace`` rates. TTFT for a request is measured from
    its TRACE arrival time — backlog a slow fleet accrues shows up as
    queueing delay, exactly as a frontend's arrival queue would.
    ``seed`` is accepted for signature parity with :func:`run_load`
    (the trace itself already carries all randomness).
    """
    del seed
    if time_scale <= 0:
        raise ValueError(f"time_scale must be > 0, got {time_scale}")
    cap_fn = getattr(engine, "capacity", None)
    if cap_fn is None:
        n_static = len(getattr(engine, "replicas", ())) or 1
        cap_fn = lambda: n_static   # noqa: E731 — static fleet
    vclock = _VirtualClock()
    set_clock = getattr(engine, "set_clock", None)
    if set_clock is not None:
        set_clock(vclock)
    handles: list = [None] * len(trace)
    at_s: list = [0.0] * len(trace)      # trace arrival time
    first_s: list = [None] * len(trace)  # virtual first-token time
    waiting: list[int] = []
    nxt = 0
    while True:
        while nxt < len(trace) and trace[nxt].at_s <= vclock.t:
            sp = trace[nxt].spec
            handles[nxt] = engine.submit(
                sp.prompt, sp.max_new_tokens,
                temperature=sp.temperature, seed=sp.seed,
                tenant=sp.tenant)
            at_s[nxt] = trace[nxt].at_s
            waiting.append(nxt)
            nxt += 1
        t_round = time.perf_counter()
        worked = engine.step()
        idle = not worked and engine.outstanding() == 0
        if not worked and not idle:
            # Idle step with work still outstanding (a router's retry
            # backoff lull runs on WALL timers): yield, and charge the
            # wait into trace time like any other round.
            time.sleep(0.001)
        dt = time.perf_counter() - t_round
        vclock.t += dt / (time_scale * max(1, cap_fn()))
        for i in list(waiting):
            h = handles[i]
            if h.cancelled or getattr(h, "shed", False):
                waiting.remove(i)
            elif len(h.tokens):
                first_s[i] = vclock.t
                waiting.remove(i)
        if idle:
            if nxt >= len(trace):
                break
            # Nothing in flight and the next arrival is in the future:
            # fast-forward the lull instead of sleeping through it.
            vclock.t = max(vclock.t, trace[nxt].at_s)
    makespan = vclock.t

    assert_atomic_cutover(
        [h for h in handles if not h.cancelled
         and not getattr(h, "shed", False)])
    weights = dict(class_weights or {})
    records = []
    for i, h in enumerate(handles):
        shed = bool(getattr(h, "shed", False))
        records.append({
            "tenant": h.tenant, "shed": shed,
            "cancelled": h.cancelled and not shed,
            "at_s": at_s[i], "tokens": len(h.tokens),
            "ttft_ms": ((first_s[i] - at_s[i]) * 1e3
                        if first_s[i] is not None else None)})
    by_tenant: dict[str, list[dict]] = {}
    for r in records:
        by_tenant.setdefault(r["tenant"], []).append(r)
    tenants = {}
    for name in sorted(by_tenant):
        hs = by_tenant[name]
        comp = [r for r in hs if not r["cancelled"] and not r["shed"]]
        n_shed = sum(r["shed"] for r in hs)
        n_canc = sum(r["cancelled"] for r in hs)
        # inf for a (theoretical) completed request with no observed
        # first token — keeps ttfts aligned with toks for the goodput
        # mask; percentiles only ever see finite values in practice.
        ttfts = np.array([r["ttft_ms"] if r["ttft_ms"] is not None
                          else np.inf for r in comp])
        toks = np.array([r["tokens"] for r in comp], dtype=int)
        if slo_ttft_ms is None:
            good = int(toks.sum()) if toks.size else 0
        else:
            good = int(toks[ttfts <= slo_ttft_ms].sum()) \
                if toks.size else 0
        tenants[name] = {
            "submitted": len(hs),
            "completed": len(comp),
            "shed": int(n_shed),
            "cancelled": int(n_canc),
            # The per-tenant identity, at HANDLE level — the engines'
            # internal ledgers assert the same thing engine-side.
            "accounting_ok": len(comp) + n_canc + n_shed == len(hs),
            "total_tokens": int(toks.sum()) if toks.size else 0,
            "good_tokens": good,
            "ttft_p50_ms": (round(float(np.percentile(ttfts, 50)), 3)
                            if ttfts.size else None),
            "ttft_p99_ms": (round(float(np.percentile(ttfts, 99)), 3)
                            if ttfts.size else None),
            "slo_attained": (round(float(
                (ttfts <= slo_ttft_ms).sum()) / len(hs), 4)
                if slo_ttft_ms is not None and len(hs) else None),
        }
    total_good = sum(t["good_tokens"] for t in tenants.values())
    # Replica-seconds: an Autoscaler integrates ∫ capacity dt; a
    # static engine/router is a constant fleet for the whole run.
    rs_fn = getattr(engine, "replica_seconds", None)
    if rs_fn is not None:
        replica_s = float(rs_fn())
    else:
        n_rep = len(getattr(engine, "replicas", ())) or 1
        replica_s = makespan * n_rep
    ta_fn = getattr(engine, "tenant_accounting_ok", None)
    out = {
        "n_requests": len(trace),
        "makespan_s": round(makespan, 4),
        "trace_span_s": (round(trace[-1].at_s, 3) if trace else 0.0),
        "time_scale": time_scale,
        "slo_ttft_ms": slo_ttft_ms,
        "n_completed": sum(t["completed"] for t in tenants.values()),
        "n_shed": sum(t["shed"] for t in tenants.values()),
        "n_cancelled": sum(t["cancelled"] for t in tenants.values()),
        "accounting_ok": all(t["accounting_ok"]
                             for t in tenants.values()),
        "tenant_accounting_ok": (bool(ta_fn()) if ta_fn is not None
                                 else None),
        "total_tokens": sum(t["total_tokens"]
                            for t in tenants.values()),
        "good_tokens": total_good,
        "goodput_tokens_per_sec": round(total_good / makespan, 3),
        "replica_seconds": round(replica_s, 4),
        "goodput_per_replica_sec": round(
            total_good / replica_s, 3) if replica_s else None,
        "slo_inversions": (_slo_inversions(records, weights,
                                           slo_ttft_ms)
                           if slo_ttft_ms is not None else None),
        "tenants": tenants,
    }
    stats_fn = getattr(engine, "stats", None)
    if stats_fn is not None and hasattr(engine, "scale_ups"):
        st = stats_fn()
        out["autoscale"] = {k: st[k] for k in
                            ("n_replicas", "capacity", "scale_ups",
                             "scale_downs", "migrated_on_drain",
                             "boot_s")}
    return out
