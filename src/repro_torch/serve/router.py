"""Request queue of the serving engine (numpy only).

The port's copy of the JAX package's ``serve/router.py``: :class:`Request`,
:class:`Completion`, the padding :class:`MicroBatcher` and the
least-loaded :class:`Router` with admission control over the alive
replicas, evacuation, gang drains, and the continuous scheduler's slot
fills (``MicroBatcher.pop``) and work stealing (``Router.steal``, which
takes a queue's newest request).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One inference request: an (H, W, C) image and its arrival time (s).
    ``cost`` is its relative service weight (1.0 nominal): the modelled
    clock charges a gang round its dearest request's ``cost`` times the
    round time."""
    rid: int
    image: np.ndarray
    t_arrival: float
    cost: float = 1.0


@dataclass
class Completion:
    """One finished request. ``status`` is ``"ok"``, or ``"failed"`` when
    replica faults used up its retry budget (``pred`` and ``replica`` are
    then -1): every admitted request ends as exactly one completion.
    ``version`` counts hot swaps (0: the compiled model, 1: the first
    ``hot_swap``'s); ``attempts`` is how often it was re-dispatched."""
    rid: int
    pred: int
    t_arrival: float
    t_done: float
    replica: int = 0
    status: str = "ok"                 # "ok" | "failed"
    version: int = 0
    attempts: int = 0

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


class MicroBatcher:
    """FIFO queue that drains requests in plan-batch-sized chunks.

    ``next_batch`` pops up to ``plan_batch`` requests and zero-pads the
    images to exactly ``plan_batch`` rows: one compiled shape, padding
    rows computed and dropped. An empty queue returns ``([], None, 0)``.
    """

    def __init__(self, plan_batch: int):
        self.plan_batch = plan_batch
        self._q: List[Request] = []

    def submit(self, req: Request) -> None:
        self._q.append(req)

    def __len__(self) -> int:
        return len(self._q)

    def next_batch(self) -> Tuple[List[Request], Optional[np.ndarray], int]:
        take, self._q = self._q[:self.plan_batch], self._q[self.plan_batch:]
        if not take:
            return [], None, 0
        imgs = np.stack([r.image for r in take])
        n_real = len(take)
        if n_real < self.plan_batch:
            pad = np.zeros((self.plan_batch - n_real,) + imgs.shape[1:],
                           imgs.dtype)
            imgs = np.concatenate([imgs, pad])
        return take, imgs, n_real

    def drain_all(self) -> List[Request]:
        """Pop the whole queue unpadded: the evacuation of a failed or
        swapping replica."""
        take, self._q = self._q, []
        return take

    def pop(self, k: int) -> List[Request]:
        """Pop up to ``k`` requests unpadded, oldest first: the continuous
        scheduler fills free slots from the head of the queue."""
        take, self._q = self._q[:k], self._q[k:]
        return take

    def steal_tail(self) -> Optional[Request]:
        """Pop the newest queued request (or None): the one that would
        wait behind the whole backlog, so a steal helps it most."""
        return self._q.pop() if self._q else None


class Router:
    """Least-loaded dispatch over N replica queues with admission control:
    with ``max_queue`` > 0 a request is rejected when the chosen queue
    already holds that many. ``alive`` (a boolean a replica) restricts
    dispatch and gang drains to the surviving replicas; down replicas
    drain as idle entries."""

    def __init__(self, n_replicas: int, plan_batch: int, *,
                 max_queue: int = 0):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.queues = [MicroBatcher(plan_batch) for _ in range(n_replicas)]
        self.max_queue = max_queue
        self.rejected: List[Request] = []
        self.last_replica = -1         # the latest dispatch's (-1: rejected)

    @property
    def n_replicas(self) -> int:
        return len(self.queues)

    def backlog(self) -> int:
        return sum(len(q) for q in self.queues)

    def dispatch(self, req: Request,
                 alive: Optional[Sequence[bool]] = None) -> bool:
        """Route one request to the least-loaded alive replica (ties to
        the lowest id); False = rejected by admission control. Raises when
        ``alive`` rules out every replica: the engine decides what a dead
        fleet means."""
        cands = [i for i in range(len(self.queues))
                 if alive is None or alive[i]]
        if not cands:
            raise RuntimeError("no alive replica to dispatch to")
        r = min(cands, key=lambda i: (len(self.queues[i]), i))
        if self.max_queue and len(self.queues[r]) >= self.max_queue:
            self.rejected.append(req)
            self.last_replica = -1
            return False
        self.queues[r].submit(req)
        self.last_replica = r
        return True

    def evacuate(self, r: int) -> List[Request]:
        """Pop every request queued on replica ``r``; the caller
        re-dispatches them."""
        return self.queues[r].drain_all()

    def depths(self) -> List[int]:
        """Queue depth a replica: the skew work stealing triggers on."""
        return [len(q) for q in self.queues]

    def steal(self, donor: int) -> Optional[Request]:
        """Take the newest request of ``donor``'s queue (None if empty).
        The caller queues it on the thief and charges its retry budget, as
        a failure's evacuation does."""
        return self.queues[donor].steal_tail()

    def drain_round(self, alive: Optional[Sequence[bool]] = None):
        """Pop one padded micro-batch per replica, a gang round:
        ``[(replica, requests, images, n_real), ...]``; idle and down
        replicas appear as ``(r, [], None, 0)``."""
        return [(r,) + (q.next_batch() if alive is None or alive[r]
                        else ([], None, 0))
                for r, q in enumerate(self.queues)]
