"""GPipe fill-drain schedule of heterogeneous CNN stages on one device.

The JAX package's ``parallel/pipeline_par.py`` runs stage s on device s of
a mesh axis and hops activations between devices with a
collective_permute: at tick t, stage s computes microbatch t - s, so M
microbatches cross S stages in M + S - 1 ticks (bubble (S-1)/(M+S-1)).
The port keeps that schedule on one card, as PipeCNN's own cascade does
on one FPGA: each stage runs on its own CUDA stream, and stage s of
microbatch m starts when stage s-1 of m has finished (an event) and stage
s of m-1 has (the order of stage s's stream), so the stages overlap.

CNN stages change the activation's shape (H shrinks, C grows, the FC
flattens). JAX needs a flat fp32 buffer of one shape because
``lax.switch`` does; here each boundary tensor passes as it is, and an
int8 pipeline's codes stay int8. A boundary tensor made on stage s's
stream and read on stage s+1's is recorded on the reader's stream
(``record_stream``), so the caching allocator cannot hand its memory out
again before the reader is done. On the CPU (``streams=None``) the same
ticks run in order, one after another.

:func:`gpipe_schedule` is the schedule of JAX's
``pipeline_forward_stages``; the serving engine splits a replica's rows
into the microbatches it takes. :func:`pipeline_forward` is JAX's
uniform-stage entry point over stage-stacked parameters, on the same
schedule.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch


def gpipe_schedule(stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
                   micro: Sequence[torch.Tensor], n_stages: int, *,
                   streams: Optional[Sequence[torch.cuda.Stream]] = None
                   ) -> List[torch.Tensor]:
    """Run every microbatch in ``micro`` through stages ``0..n_stages-1``
    (``stage_fn(s, h) -> h``) in fill-drain ticks; returns the last
    stage's output a microbatch, ready on the caller's current stream.

    ``streams`` (one a stage, CUDA only) runs stage s on ``streams[s]``;
    without them the ticks run in order on the current stream or the
    CPU."""
    M, S = len(micro), n_stages
    h = list(micro)
    if streams is None:
        for t in range(M + S - 1):
            for s in range(S):
                if 0 <= t - s < M:
                    h[t - s] = stage_fn(s, h[t - s])
        return h
    if len(streams) != S:
        raise ValueError(f"{len(streams)} streams for {S} stages")
    entry = torch.cuda.current_stream(h[0].device)
    streams[0].wait_stream(entry)      # the microbatches are the caller's
    done = [[None] * M for _ in range(S)]
    for t in range(M + S - 1):
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            st = streams[s]
            # stage s of m: after stage s-1 of m (its event) and stage s
            # of m-1 (earlier on this stream)
            if s:
                st.wait_event(done[s - 1][m])
            h[m].record_stream(st)
            with torch.cuda.stream(st):
                h[m] = stage_fn(s, h[m])
                done[s][m] = torch.cuda.Event()
                done[s][m].record(st)
    for m in range(M):
        entry.wait_event(done[S - 1][m])
        h[m].record_stream(entry)
    return h



def _stage(tree: Any, s: int) -> Any:
    """Stage ``s``'s slice of a stage-stacked tensor or dict of them."""
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def _n_stages(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     params_stacked: Any, x: torch.Tensor,
                     n_microbatches: int = 4, *,
                     streams: Optional[Sequence[torch.cuda.Stream]] = None
                     ) -> torch.Tensor:
    """Run x through S uniform pipeline stages.

    ``stage_fn(stage_params, h) -> h`` applies one stage's layers;
    ``params_stacked`` is a tensor or a dict tree whose leaves lead with
    the stage axis S (stage s's parameters are every leaf at s). x (B,
    ...) is cut into ``n_microbatches`` along dim 0, which must divide B.
    The microbatches cross the stages in :func:`gpipe_schedule`'s
    fill-drain ticks, stage s on ``streams[s]`` where given. Returns the
    last stage's output, (B, ...)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"pipeline_forward: batch {B} is not a multiple of "
                         f"{n_microbatches} microbatches")
    S = _n_stages(params_stacked)
    stages = [_stage(params_stacked, s) for s in range(S)]
    micro = list(x.reshape(n_microbatches, B // n_microbatches,
                           *x.shape[1:]).unbind(0))
    out = gpipe_schedule(lambda s, h: stage_fn(stages[s], h), micro, S,
                         streams=streams)
    return torch.cat(out)
