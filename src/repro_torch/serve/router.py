"""Request queue of the serving engine (numpy only).

The port's copy of the JAX package's ``serve/router.py``, cut to what the
gang scheduler of one replica uses: :class:`Request`, :class:`Completion`,
the padding :class:`MicroBatcher` and the least-loaded :class:`Router`
with admission control.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Request:
    """One inference request: an (H, W, C) image and its arrival time (s)."""
    rid: int
    image: np.ndarray
    t_arrival: float


@dataclass
class Completion:
    """One finished request (``status`` "ok"; "failed" comes with faults)."""
    rid: int
    pred: int
    t_arrival: float
    t_done: float
    status: str = "ok"

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


class Router:
    """Least-loaded dispatch over N replica queues with admission control:
    with ``max_queue`` > 0 a request is rejected when the chosen queue
    already holds that many."""

    def __init__(self, n_replicas: int, plan_batch: int, *,
                 max_queue: int = 0):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.queues = [MicroBatcher(plan_batch) for _ in range(n_replicas)]
        self.max_queue = max_queue
        self.rejected: List[Request] = []

    def backlog(self) -> int:
        return sum(len(q) for q in self.queues)

    def dispatch(self, req: Request) -> bool:
        """Route one request; False = rejected by admission control."""
        r = min(range(len(self.queues)),
                key=lambda i: (len(self.queues[i]), i))
        if self.max_queue and len(self.queues[r]) >= self.max_queue:
            self.rejected.append(req)
            return False
        self.queues[r].submit(req)
        return True

    def drain_round(self):
        """Pop one padded micro-batch per replica — a gang round:
        ``[(replica, requests, images, n_real), ...]``."""
        return [(r,) + q.next_batch() for r, q in enumerate(self.queues)]
