"""Device prefetch: keep the next batches' host-to-device copies in
flight (tpu_ddp/data/prefetch.py).

The reference overlaps host work with the step through DataLoader
workers and ``pin_memory=True`` (part1/main.py:36-41). Here
:func:`prefetch_to_device` calls ``put_fn`` (``Trainer.put_batch``) on
the next ``depth`` batches before the current step is consumed. On the
card ``put_batch`` pins the host batch, copies it on a side stream and
records an event; the step makes the compute stream wait on that event
(and ``record_stream`` tells the allocator the tensors are used there),
so the copies of batches i+1..i+depth run while step i computes.

Composition (the JAX package's rules):

- the dispatch window (train/pipeline.py) overlaps result harvesting
  with compute; prefetch overlaps copies with compute. The epoch loop
  runs both.
- fault injection: only a fault that poisons a batch on the host at an
  exact step (``nan-grad``, ``FaultInjector.poisons_batches``) turns
  prefetch off; the passive kinds compose with it.
- K steps per dispatch (``steps_per_dispatch > 1``): not composed; the
  grouped loop stages K batches per dispatch through ``put_batches``,
  and ``device_prefetch`` sends the loop down the per-step path.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator


def prefetch_to_device(batches: Iterable, put_fn: Callable, depth: int = 2
                       ) -> Iterator:
    """Yield ``put_fn(*batch)`` results with ``depth`` puts ahead of the
    consumer; ``depth=0`` is the plain mapping. A negative depth raises
    (it would silently become the plain mapping, hiding a typo)."""
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth} "
                         "(0 = no lookahead)")

    def put(b):
        return put_fn(*b) if isinstance(b, tuple) else put_fn(b)

    if depth == 0:
        for b in batches:
            yield put(b)
        return
    it = iter(batches)
    queue = collections.deque()
    try:
        while len(queue) < depth:
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        yield queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            continue
