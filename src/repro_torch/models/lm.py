"""Unified LM: one functional model covering all ten assigned architectures.

A copy of the JAX package's ``models/lm.py`` in plain PyTorch, as the JAX
model is plain XLA: no kernel of the port runs here.

Families:
  dense / vlm / audio  -> pre-norm GQA transformer (qk_norm optional);
                          vlm/audio prepend stubbed frontend embeddings.
  moe                  -> transformer with capacity-dispatch MoE FFN
                          (+ Arctic's parallel dense residual).
  ssm (xLSTM)          -> alternating mLSTM / sLSTM pairs.
  hybrid (Zamba2)      -> Mamba2 stack with ONE SHARED attention+MLP block
                          applied every ``attn_every`` layers.

Parameters are the JAX tree: nested dicts whose ``blocks`` leaves carry a
leading layer axis (JAX's ``vmap`` of the block init), so
:func:`params_from_jax` carries JAX's parameters across as they are. The
layer loops are Python loops over that axis, and JAX's ``lax.cond`` on a
static flag is a Python ``if`` on the layer index. Vocab is padded to a
multiple of 256; the pad columns are masked out of the loss
(:func:`loss_fn`) and the decode argmax (``train/steps.py``). Training
differentiates :func:`loss_fn` with autograd; :func:`maybe_remat` is
JAX's per-layer ``jax.checkpoint`` as ``torch.utils.checkpoint``. JAX's
sharding annotations (``parallel.sharding.shard``) sit where JAX has them;
they act only on DTensors inside ``sharding_ctx`` (the dry run) and are
no-ops otherwise. :func:`cache_logical_axes`, :func:`batch_logical_axes`
and :func:`input_specs` (``meta`` tensors for JAX's ``ShapeDtypeStruct``)
feed the dry run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core.config import ModelConfig
from repro_torch.models import ssm as S
from repro_torch.models.attention import (KVCache, attn_decode, attn_forward,
                                          init_attn_params, init_kv_cache,
                                          params_from_jax)
from repro_torch.models.layers import (cross_entropy, dense_init, dtype_of,
                                       embed_init, rms_norm)
from repro_torch.models.mlp import (init_mlp_params, init_moe_params,
                                    mlp_forward, moe_forward)
from repro_torch.parallel.sharding import (matmul, put_prefix, shard,
                                           take_rows, unshard)
from repro_torch.pipeline.compile import resolve_device

__all__ = ["VOCAB_ALIGN", "DecodeCache", "batch_logical_axes",
           "cache_logical_axes", "count_params", "decode_step", "forward",
           "init_decode_cache", "init_params", "input_specs", "loss_fn",
           "maybe_remat", "n_scan_steps", "n_shared_attn_apps",
           "pad_mask", "params_from_jax", "prefill", "tree_leaves",
           "tree_map", "vocab_padded"]

VOCAB_ALIGN = 256
TRANSFORMER_FAMILIES = ("dense", "vlm", "audio", "moe")

Tree = Dict[str, Any]


def vocab_padded(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_ALIGN) * VOCAB_ALIGN


def pad_mask(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 on the padded vocab columns, 0 elsewhere, in the logits'
    dtype (JAX's weakly typed mask keeps bf16 logits bf16)."""
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return torch.where(pad, -1e30, 0.0).to(logits.dtype)


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat ``"dots"``: keep the outputs
    of the products without batch dimensions (``mm``/``addmm``, what
    JAX's ``dots_with_no_batch_dims_saveable`` keeps), recompute the rest
    (the batched ``bmm`` of the attention scores and the scans too)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_save_products)


def maybe_remat(body: Callable, cfg: ModelConfig) -> Callable:
    """Per-layer activation checkpointing with a configurable policy.

    "full": recompute the whole layer in the backward pass (least memory,
    most recompute). "dots": keep the matmul outputs and recompute the
    rest. Values are unchanged either way: the recompute runs the same
    operations on the same inputs."""
    if not cfg.remat:
        return body
    kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}

    def run(*args):
        return _ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on every tensor of a parameter tree (nested dicts), and on
    the tensors at the same paths of the trees in ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: Tree, path=()):
    """(path of keys, tensor) for every leaf of a parameter tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _layer(blocks: Tree, i: int) -> Tree:
    """Layer ``i``'s parameters: every stacked leaf at index ``i``
    (gathered over the FSDP axes in the dry run: ``sharding.unshard``)."""
    return unshard(tree_map(lambda a: a[i], blocks))


def _layers(blocks: Tree, n: int):
    """The ``n`` layers' parameters, each stacked leaf unbound once. Under
    autograd each index ``a[i]`` of :func:`_layer` would write a
    zero-filled gradient the size of the whole stack, L times the stacked
    gradient's bytes; an unbind's backward stacks the layers' gradients
    once. The views hold the values indexing gives."""
    parts = tree_map(lambda a: a.unbind(0), blocks)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _stack_states(states, kind):
    """Per-layer recurrent states stacked field by field on a new axis 0."""
    return kind(*map(torch.stack, zip(*states)))


# ===========================================================================
# Parameter initialization
# ===========================================================================

def _init_transformer_block(cfg: ModelConfig, dtype, g, device) -> Tree:
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=device)
    p = {"ln1": ones(), "attn": init_attn_params(cfg, dtype, g, device),
         "ln2": ones()}
    if cfg.is_moe:
        p["moe"] = init_moe_params(cfg, dtype, g, device)
    else:
        p["mlp"] = init_mlp_params(cfg, dtype, g, device)
    return p


def _init_hybrid_block(cfg: ModelConfig, dtype, g, device) -> Tree:
    return {"ln": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "mamba": S.init_mamba_params(cfg, dtype, g, device)}


def _init_xlstm_pair(cfg: ModelConfig, dtype, g, device) -> Tree:
    ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=device)
    return {"ln_m": ones(), "mlstm": S.init_mlstm_params(cfg, dtype, g,
                                                         device),
            "ln_s": ones(), "slstm": S.init_slstm_params(cfg, dtype, g,
                                                         device)}


def n_scan_steps(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        assert cfg.n_layers % 2 == 0, "xLSTM alternates in pairs"
        return cfg.n_layers // 2
    return cfg.n_layers


def n_shared_attn_apps(cfg: ModelConfig) -> int:
    if cfg.attn_every:
        return len(range(0, cfg.n_layers, cfg.attn_every))
    return 0


def _stacked(n: int, make: Callable[[], Tree]) -> Tree:
    """``n`` blocks' parameters stacked on a leading axis. Each block is
    drawn (in fp32, then cast) on its own and copied into its slot, so the
    fp32 draw of a whole stack is never live at once."""
    first = make()
    out = tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    for i in range(n):
        block = first if i == 0 else make()
        for path, leaf in tree_leaves(block):
            dst = out
            for k in path:
                dst = dst[k]
            dst[i].copy_(leaf)
        del block
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Tree:
    """Random parameters from ``generator``, on ``device`` (the CUDA
    device by default, which raises when there is none), with the JAX
    package's tree, shapes, dtypes and scales. torch's generator cannot
    reproduce ``jax.random``: to compare with JAX, carry its parameters
    across with :func:`params_from_jax`. On ``device="meta"`` nothing is
    allocated (:func:`count_params`)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    Vp = vocab_padded(cfg)
    g = generator
    params: Tree = {
        "embed": embed_init((Vp, cfg.d_model), dtype, g, device),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "lm_head": dense_init((cfg.d_model, Vp), dtype, g, device),
    }
    if cfg.frontend:
        params["frontend_proj"] = dense_init((cfg.d_model, cfg.d_model),
                                             dtype, g, device)
    block_init = {
        "dense": _init_transformer_block, "vlm": _init_transformer_block,
        "audio": _init_transformer_block, "moe": _init_transformer_block,
        "hybrid": _init_hybrid_block, "ssm": _init_xlstm_pair,
    }[cfg.family]
    params["blocks"] = _stacked(n_scan_steps(cfg),
                                lambda: block_init(cfg, dtype, g, device))
    if cfg.attn_every:  # Zamba2: the single shared attention+MLP block
        ones = lambda: torch.ones(cfg.d_model, dtype=dtype, device=device)
        params["shared"] = {
            "ln1": ones(), "attn": init_attn_params(cfg, dtype, g, device),
            "ln2": ones(), "mlp": init_mlp_params(cfg, dtype, g, device)}
    return params


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes on the ``meta`` device (no
    memory allocated)."""
    params = init_params(cfg, torch.Generator(), device="meta")
    total = 0
    for path, leaf in tree_leaves(params):
        n = leaf.numel()
        if active_only and any(k in ("moe_wi", "moe_wdown") for k in path):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


# ===========================================================================
# Forward (train / prefill)
# ===========================================================================

def _embed_tokens(params: Tree, tokens: torch.Tensor,
                  frontend_embed: Optional[torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    x = take_rows(params["embed"], tokens)
    if cfg.frontend:
        fe = matmul(frontend_embed.to(x.dtype),
                    unshard(params["frontend_proj"]))
        x = torch.cat([fe, x], dim=1)
    return shard(x, "batch", "seq", "embed")


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _ffn(bp: Tree, inner: torch.Tensor, cfg: ModelConfig):
    if cfg.is_moe:
        return moe_forward(bp["moe"], inner, cfg)
    return mlp_forward(bp["mlp"], inner), None


def _transformer_block_fwd(bp: Tree, x, cfg: ModelConfig, positions):
    x = x + attn_forward(bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                         cfg, positions)
    f, aux = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    return shard(x + f, "batch", "seq", "embed"), aux


def _shared_block_fwd(sp: Tree, x, cfg: ModelConfig, positions):
    x = x + attn_forward(sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps),
                         cfg, positions)
    return x + mlp_forward(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps))


def _xlstm_pair_fwd(bp: Tree, x, cfg: ModelConfig, mst=None, sst=None):
    h, mst = S.mlstm_forward(bp["mlstm"],
                             rms_norm(x, bp["ln_m"], cfg.norm_eps), cfg, mst)
    x = x + h
    h, sst = S.slstm_forward(bp["slstm"],
                             rms_norm(x, bp["ln_s"], cfg.norm_eps), cfg, sst)
    return x + h, mst, sst


def forward(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
            frontend_embed: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """Full-sequence forward -> logits (B, S_total, V_padded)[, aux]."""
    x = _embed_tokens(params, tokens, frontend_embed, cfg)
    B, Stot, _ = x.shape
    positions = _positions(B, Stot, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _layers(params["blocks"], n_scan_steps(cfg))

    if cfg.family in TRANSFORMER_FAMILIES:
        def body(x, bp):
            x, aux = _transformer_block_fwd(unshard(bp), x, cfg, positions)
            return x, aux_total if aux is None else aux
        body = maybe_remat(body, cfg)
        auxs = []
        for bp in layers:
            x, aux = body(x, bp)
            auxs.append(aux)
        aux_total = torch.stack(auxs).sum()

    elif cfg.family == "hybrid":
        sp = params["shared"]

        def body(x, bp, shared):
            bp = unshard(bp)
            if shared:
                x = _shared_block_fwd(unshard(sp), x, cfg, positions)
            h, _ = S.mamba_forward(bp["mamba"],
                                   rms_norm(x, bp["ln"], cfg.norm_eps), cfg)
            return shard(x + h, "batch", "seq", "embed")
        body = maybe_remat(body, cfg)
        for i, bp in enumerate(layers):
            x = body(x, bp, i % cfg.attn_every == 0)

    elif cfg.family == "ssm":
        def body(x, bp):
            return shard(_xlstm_pair_fwd(unshard(bp), x, cfg)[0],
                         "batch", "seq", "embed")
        body = maybe_remat(body, cfg)
        for bp in layers:
            x = body(x, bp)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard(matmul(x, unshard(params["lm_head"])), "batch", "seq",
                   "vocab")
    if return_aux:
        return logits, aux_total
    return logits


def loss_fn(params: Tree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token NLL over the real vocab, plus ``aux_weight`` x the
    MoE load-balancing loss; the logits are cut to the token positions
    when the config has a frontend."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          batch.get("frontend_embed"), return_aux=True)
    if cfg.frontend:                    # loss only over the token positions
        logits = logits[:, cfg.frontend_len:]
    loss = cross_entropy(logits + pad_mask(logits, cfg), batch["labels"])
    return loss + aux_weight * aux


# ===========================================================================
# Serving: prefill + decode with caches
# ===========================================================================

class DecodeCache(NamedTuple):
    """Unified cache across families (unused fields are size-0 tensors)."""
    kv: Any                 # KVCache, stacked (L, ...)  [transformer fams]
    mamba: Any              # MambaState, stacked (L, ...) [hybrid]
    mlstm: Any              # MLSTMState stacked (L/2,...) [ssm]
    slstm: Any              # SLSTMState stacked (L/2,...) [ssm]
    shared_kv: Any          # KVCache (A, ...) for the shared block [hybrid]
    pos: torch.Tensor       # 0-d int32 on the device: tokens so far


def init_decode_cache(cfg: ModelConfig, batch: int, s_max: int,
                      device=None) -> DecodeCache:
    """Zeroed caches on ``device`` (the CUDA device by default, which
    raises when there is none)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    L = cfg.n_layers
    empty = torch.zeros(0, dtype=dtype, device=device)
    kv = mamba = mlstm = slstm = shared = empty
    if cfg.family in TRANSFORMER_FAMILIES:
        kv = init_kv_cache(cfg, batch, s_max, dtype, device, n_layers=L)
    elif cfg.family == "hybrid":
        mamba = S.init_mamba_state(cfg, batch, dtype, device, n_layers=L)
        shared = init_kv_cache(cfg, batch, s_max, dtype, device,
                               n_layers=n_shared_attn_apps(cfg))
    elif cfg.family == "ssm":
        mlstm = S.init_mlstm_state(cfg, batch, device, n_layers=L // 2)
        slstm = S.init_slstm_state(cfg, batch, device, n_layers=L // 2)
    return DecodeCache(kv, mamba, mlstm, slstm, shared,
                       torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params: Tree, tokens: torch.Tensor, cache: DecodeCache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeCache]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, Vp), new cache).
    Functional, as in JAX: the cache passed in is left as it was."""
    x = shard(take_rows(params["embed"], tokens), "batch", "seq", "embed")
    pos = cache.pos
    blocks = params["blocks"]

    if cfg.family in TRANSFORMER_FAMILIES:
        ks, vs = torch.empty_like(cache.kv.k), torch.empty_like(cache.kv.v)
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h, new_kv = attn_decode(
                bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps), cfg,
                KVCache(cache.kv.k[i], cache.kv.v[i]), pos)
            ks[i], vs[i] = new_kv
            x = x + h
            f, _ = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
            x = x + f
        cache = cache._replace(kv=KVCache(ks, vs))

    elif cfg.family == "hybrid":
        sp = unshard(params["shared"])
        sh_k, sh_v = cache.shared_kv.k.clone(), cache.shared_kv.v.clone()
        states = []
        for i in range(cfg.n_layers):
            if i % cfg.attn_every == 0:
                a = i // cfg.attn_every          # this application's cache
                h, new_kv = attn_decode(
                    sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps), cfg,
                    KVCache(sh_k[a], sh_v[a]), pos)
                x = x + h
                x = x + mlp_forward(sp["mlp"],
                                    rms_norm(x, sp["ln2"], cfg.norm_eps))
                sh_k[a], sh_v[a] = new_kv
            bp = _layer(blocks, i)
            h, st = S.mamba_decode(
                bp["mamba"], rms_norm(x, bp["ln"], cfg.norm_eps), cfg,
                S.MambaState(cache.mamba.ssm[i], cache.mamba.conv[i]))
            x = x + h
            states.append(st)
        cache = cache._replace(mamba=_stack_states(states, S.MambaState),
                               shared_kv=KVCache(sh_k, sh_v))

    elif cfg.family == "ssm":
        msts, ssts = [], []
        for i in range(n_scan_steps(cfg)):
            x, mst, sst = _xlstm_pair_fwd(
                _layer(blocks, i), x, cfg,
                S.MLSTMState(*(a[i] for a in cache.mlstm)),
                S.SLSTMState(*(a[i] for a in cache.slstm)))
            msts.append(mst)
            ssts.append(sst)
        cache = cache._replace(mlstm=_stack_states(msts, S.MLSTMState),
                               slstm=_stack_states(ssts, S.SLSTMState))

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = matmul(x, unshard(params["lm_head"]))
    return logits, cache._replace(pos=pos + 1)


def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: int, frontend_embed: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, DecodeCache]:
    """Process a full prompt, build the decode cache, return last logits.

    For transformer families the KV cache is populated with the K and V
    the attention projected (JAX projects them a second time, which XLA
    merges); recurrent families carry their final states."""
    B = tokens.shape[0]
    x = _embed_tokens(params, tokens, frontend_embed, cfg)
    cache = init_decode_cache(cfg, B, s_max, x.device)
    Stot = x.shape[1]
    positions = _positions(B, Stot, x.device)
    blocks = params["blocks"]

    if cfg.family in TRANSFORMER_FAMILIES:
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            normed = rms_norm(x, bp["ln1"], cfg.norm_eps)
            h, k, v = attn_forward(bp["attn"], normed, cfg, positions,
                                   return_kv=True)
            put_prefix(cache.kv.k, i, k)
            put_prefix(cache.kv.v, i, v)
            x = x + h
            f, _ = _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
            x = x + f

    elif cfg.family == "hybrid":
        sp = unshard(params["shared"])
        states = []
        for i in range(cfg.n_layers):
            if i % cfg.attn_every == 0:
                a = i // cfg.attn_every
                normed = rms_norm(x, sp["ln1"], cfg.norm_eps)
                h, k, v = attn_forward(sp["attn"], normed, cfg, positions,
                                       return_kv=True)
                put_prefix(cache.shared_kv.k, a, k)   # zero-padded to s_max
                put_prefix(cache.shared_kv.v, a, v)
                x = x + h
                x = x + mlp_forward(sp["mlp"],
                                    rms_norm(x, sp["ln2"], cfg.norm_eps))
            bp = _layer(blocks, i)
            h, st = S.mamba_forward(
                bp["mamba"], rms_norm(x, bp["ln"], cfg.norm_eps), cfg)
            x = x + h
            states.append(st)
        cache = cache._replace(mamba=_stack_states(states, S.MambaState))

    elif cfg.family == "ssm":
        msts, ssts = [], []
        for i in range(n_scan_steps(cfg)):
            x, mst, sst = _xlstm_pair_fwd(_layer(blocks, i), x, cfg)
            msts.append(mst)
            ssts.append(sst)
        cache = cache._replace(mlstm=_stack_states(msts, S.MLSTMState),
                               slstm=_stack_states(ssts, S.SLSTMState))

    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = matmul(x, unshard(params["lm_head"]))
    return logits, cache._replace(
        pos=torch.full((), Stot, dtype=torch.int32, device=x.device))


def cache_logical_axes(cfg: ModelConfig) -> DecodeCache:
    """DecodeCache-shaped tree of logical-axis tuples (for shardings).

    Mirrors init_decode_cache's structure exactly; leaves are tuples of
    logical axis names consumed by parallel.sharding.spec_for.
    """
    kv_ax = KVCache(("layers", "batch", "kvseq", None, None),
                    ("layers", "batch", "kvseq", None, None))
    none = ()
    kv = mamba = mlstm = slstm = shared = none
    if cfg.family in TRANSFORMER_FAMILIES:
        kv = kv_ax
    elif cfg.family == "hybrid":
        mamba = S.MambaState(("layers", "batch", "heads", None, None),
                             ("layers", "batch", None, "ffn"))
        shared = kv_ax
    elif cfg.family == "ssm":
        mlstm = S.MLSTMState(("layers", "batch", "heads", None, None),
                             ("layers", "batch", "heads", None),
                             ("layers", "batch", "heads"))
        slstm = S.SLSTMState(*(("layers", "batch", "heads", None),) * 4)
    return DecodeCache(kv, mamba, mlstm, slstm, shared, ())


def batch_logical_axes(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Logical axes for the input batch dict of a given step kind."""
    tok = ("batch", None)
    if kind == "train":
        ax = {"tokens": tok, "labels": tok}
    elif kind == "prefill":
        ax = {"tokens": tok}
    else:
        return {"tokens": tok, "cache": cache_logical_axes(cfg)}
    if cfg.frontend:
        ax["frontend_embed"] = ("batch", None, None)
    return ax


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell
    (JAX's ``ShapeDtypeStruct``s): its shapes and dtypes, nothing
    allocated. ``shape`` is a ``core.config.ShapeSpec``."""
    B, Sq = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    F = cfg.frontend_len if cfg.frontend else 0

    def tokens(n):
        return torch.empty((B, n), dtype=torch.int32, device=meta)

    if shape.kind == "decode":      # one new token against a cache of Sq
        return {"tokens": tokens(1),
                "cache": init_decode_cache(cfg, B, Sq, meta)}
    specs = {"tokens": tokens(Sq - F)}
    if shape.kind == "train":
        specs["labels"] = tokens(Sq - F)
    if F:
        specs["frontend_embed"] = torch.empty(
            (B, F, cfg.d_model), dtype=dtype_of(cfg.dtype), device=meta)
    return specs
