"""Model building blocks in PyTorch: the reference's ``models/layers.py``.

Conventions, as the reference's:
  * a layer's weights are a mapping from the reference's names to tensors -- a
    plain dict, or a ``Weights`` module (``models/transformer.py`` holds one
    per attention, MLP and embedding), laid out as the reference's: ``x @ w``
    with ``w`` of shape (in, out);
  * compute runs in the activations' dtype: each weight is cast to it where
    it is used, a no-op for the port's serving weights (stored once in
    ``cfg.dtype``) and the reference's own cast of its f32 weights otherwise;
    norm scales stay f32, as ``rms_norm`` reads them;
  * the init functions draw f32 weights from a ``torch.Generator`` with the
    reference's shapes and scales (the draws themselves differ from JAX's);
  * the reference's ``shard``/``wcast`` sharding constraints stand where the
    reference has them (``models/sharding_ctx.py``): the identity without a
    mesh context, a DTensor ``redistribute`` under one; ``flash_attention``
    pads the heads with zero heads when the context's ``model`` axis does not
    divide them, as the reference does;
  * the reference's init functions also return each weight's *logical*
    sharding spec; here the ``*_specs`` functions give them, the same tuples
    of None | "fsdp" | "tp" | ("tp"|"fsdp", dim_size) per dimension, which
    ``launch/mesh.py`` resolves against a mesh.

Attention is plain torch ops in the reference's order of casts and sums
(f32 accumulation, the ``-1e30`` mask), not a library attention kernel; the
MoE layer is the reference's GShard einsum formulation, with its (G, g, E,
cap) dispatch and combine tensors.

Entry points that make weights or state (each family's ``init``,
``init_state``/``init_cache``, ``params_from_reference``) put them on the card
unless ``device`` says otherwise (``resolve_device``); the helpers here take
the device they are given.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding_ctx import (axis_size, get_mesh, is_dtensor, shard, tp_divides,
                                              tp_splits)

Params = Mapping[str, torch.Tensor]
NEG_INF = -1e30     # the reference's mask value


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when that is the card
    and no CUDA device is available (the CPU must be asked for)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on CUDA unless device='cpu' is passed, and no "
                           "CUDA device is available")
    return device


class Weights(nn.Module):
    """A layer's weights as frozen parameters, read by name like the
    reference's dicts (``p["wq"]``), so every function here takes either.
    Stored in ``dtype``, but the names in ``keep`` in f32: what the reference
    reads in f32 (norm scales, decays, biases of f32 sums).  Training holds
    them in f32 and unfrozen (``transformer.LM.trainable``)."""

    def __init__(self, params: Params, dtype: torch.dtype = torch.float32,
                 keep: frozenset[str] = frozenset()):
        super().__init__()
        for k, v in params.items():
            t = torch.as_tensor(v).to(torch.float32 if k in keep else dtype)
            self.register_parameter(k, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def tree(self) -> dict[str, nn.Parameter]:
        """The parameters by name (a module built from them shares no
        gradient with them: ``nn.Parameter`` detaches its input)."""
        return dict(self._parameters)


def remat(policy, fn, *args):
    """``fn(*args)`` -- one layer -- under the activation checkpoint
    ``policy`` (a context function from ``train.remat.get_policy``; None runs
    it plainly), as the reference's ``jax.checkpoint`` of its scan body."""
    if policy is None:
        return fn(*args)
    # no layer draws random numbers, so there is no RNG state to stash and
    # restore around the recompute (on the card that would copy it each time)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=policy,
                      preserve_rng_state=False)


# --------------------------------------------------------------------- init helpers

def ninit(gen: torch.Generator | None, shape, scale: float | None = None,
          device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def zinit(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def oinit(shape, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


# ------------------------------------------------------------------------ norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ------------------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd)


def rope_cos_sin(pos: torch.Tensor, freqs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """pos (..., S) and f32 ``freqs`` (hd/2,) -> cos, sin of shape (..., S, 1, hd/2)."""
    ang = pos[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated by ``rope_cos_sin``'s tables (in f32, as the
    reference's bf16-times-f32 products are), back in x's dtype."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), pos: broadcastable to (..., S)."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    return rotate(x, *rope_cos_sin(pos, freqs))


def mrope_cos_sin(pos3: torch.Tensor, freqs: torch.Tensor,
                  sections: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE's tables: pos3 (..., 3, S) are (t, h, w) position ids;
    the hd/2 frequency bands split into ``sections``, each band's angle taken
    from its own stream -> cos, sin of shape (..., S, 1, hd/2)."""
    if sum(sections) != freqs.shape[0]:
        raise ValueError(f"sections {sections} do not split {freqs.shape[0]} bands")
    band_src = torch.from_numpy(np.concatenate([np.full(s, i) for i, s in
                                                enumerate(sections)])).to(pos3.device)
    pos_sel = pos3.index_select(-2, band_src)                  # (..., hd/2, S)
    ang = pos_sel.movedim(-2, -1).float() * freqs              # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by M-RoPE (Qwen2-VL) at pos3 (..., 3, S)."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    return rotate(x, *mrope_cos_sin(pos3, freqs, sections))


# -------------------------------------------------------------------- attention

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 1024, kv_chunk: int = 1024,
                    kv_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention; never materializes (Sq, Sk) scores.

    q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd).  GQA handled by head repetition.
    kv_offset: absolute position of k[0] relative to q[0] (for cross-chunk decode).

    On DTensors under a mesh context the heads split over TP and the batch
    over the FSDP axes (the reference's constraints on its chunked q, k and
    v), and each device runs the chunked attention on its own slices: the
    work is independent per batch row and head, so no collective is needed
    (``DTensor`` would otherwise gather the score blocks where its rules for
    the products' merged (batch, head) dimension disagree, ROADMAP §3).
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    # head padding: when H does not divide the TP axis, pad with zero heads so the
    # attention shards instead of replicating per TP rank; the padded outputs are
    # sliced off, so the math is exact and padded projections get zero gradients
    H_orig = H
    mesh = get_mesh()
    tp_size = axis_size(mesh, "model") if mesh is not None else 1
    if H % tp_size:
        H = -(-H // tp_size) * tp_size
        q = torch.cat([q, q.new_zeros((B, Sq, H - H_orig, hd))], dim=2)
        zk = k.new_zeros((B, Sk, H - H_orig, hd))
        k = torch.cat([k, zk], dim=2)
        v = torch.cat([v, zk], dim=2)
    q, k, v = (shard(t, "fsdp", None, "tp", None) for t in (q, k, v))
    if mesh is not None and is_dtensor(q):
        from torch.distributed.tensor import DTensor

        out = _flash(q.to_local(), k.to_local(), v.to_local(), causal, q_chunk, kv_chunk,
                     kv_offset)
        out = DTensor.from_local(out, mesh, q.placements, run_check=False)
    else:
        out = _flash(q, k, v, causal, q_chunk, kv_chunk, kv_offset)
    if H == H_orig:
        return out
    out = shard(out, "fsdp", None, None, None)    # the heads whole, then unpadded
    return out[:, :, :H_orig]


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_chunk: int,
           kv_chunk: int, kv_offset: int) -> torch.Tensor:
    """``flash_attention`` on plain tensors, the heads already repeated."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: {(Sq, q_chunk, Sk, kv_chunk)}")
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qb = q.reshape(B, nq, q_chunk, H, hd).float()
    kb = k.reshape(B, nk, kv_chunk, H, hd).float()
    vb = v.reshape(B, nk, kv_chunk, H, hd).float()
    outs = []
    for qi in range(nq):
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev) + kv_offset
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bqhd,bkhd->bhqk", qb[:, qi], kb[:, ki]) * scale
            if causal:
                k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb[:, ki])
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=1)                      # (B, nq, H, q_chunk, hd)
    out = out.transpose(2, 3).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int | torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, Hkv, hd); cache_len: an int or (B,) valid
    length.  Scores and the weighted sum accumulate in f32 (the cache is read
    in its storage dtype and widened exactly); ``p`` is cast to the cache's
    dtype first, as the reference does."""
    mesh = get_mesh()
    if mesh is not None and is_dtensor(k_cache) and isinstance(cache_len, int):
        # the cache split by batch and kv heads: each device attends its own
        # rows and heads on local tensors (DTensor's search over the product's
        # splits takes minutes a layer on a 3-axis mesh); a cache split along
        # the sequence goes through DTensor's ops
        q, k_cache, v_cache = (shard(t, "fsdp", None, "tp", None) for t in (q, k_cache, v_cache))
        if k_cache.placements == q.placements:
            from torch.distributed.tensor import DTensor

            out = attention_decode(q.to_local(), k_cache.to_local(), v_cache.to_local(),
                                   cache_len)
            return DTensor.from_local(out, mesh, q.placements, run_check=False)
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) / math.sqrt(hd)
    if isinstance(cache_len, int):
        if cache_len < S:
            s[..., max(cache_len, 0):].fill_(NEG_INF)     # fill_: the same ops on every device
    else:
        pos = torch.arange(S, device=s.device)
        valid = pos[None, :] < cache_len.reshape(-1, 1)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(k_cache.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_init(gen: torch.Generator | None, cfg: ModelConfig,
                   d_model: int | None = None, device=None) -> dict[str, torch.Tensor]:
    D = d_model or cfg.d_model
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": ninit(gen, (D, H * hd), device=device),
        "wk": ninit(gen, (D, Hkv * hd), device=device),
        "wv": ninit(gen, (D, Hkv * hd), device=device),
        "wo": ninit(gen, (H * hd, D), scale=1.0 / math.sqrt(H * hd), device=device),
    }
    if cfg.qkv_bias:
        params |= {"bq": zinit((H * hd,), device), "bk": zinit((Hkv * hd,), device),
                   "bv": zinit((Hkv * hd,), device)}
    return params


def attention_specs(cfg: ModelConfig) -> dict[str, tuple]:
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {"wq": ("fsdp", ("tp", H * hd)), "wk": ("fsdp", ("tp", Hkv * hd)),
             "wv": ("fsdp", ("tp", Hkv * hd)), "wo": (("tp", H * hd), "fsdp")}
    if cfg.qkv_bias:
        specs |= {"bq": (("tp", H * hd),), "bk": (("tp", Hkv * hd),),
                  "bv": (("tp", Hkv * hd),)}
    return specs


def attention_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Project to (q, k, v) with head reshape; x (B, S, D)."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ wcast(p["wq"], dt, "fsdp", "tp")
    k = x @ wcast(p["wk"], dt, "fsdp", "tp")
    v = x @ wcast(p["wv"], dt, "fsdp", "tp")
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (shard(_split_heads(q, H, hd), "fsdp", None, "tp", None),
            shard(_split_heads(k, Hkv, hd), "fsdp", None, "tp", None),
            shard(_split_heads(v, Hkv, hd), "fsdp", None, "tp", None))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), the output projection's input.  Under
    a context whose TP axis does not split the heads the width is pinned
    whole: its gradient, split over TP by the projection, could not be
    viewed back into heads."""
    y = x.reshape(*x.shape[:-2], -1)
    return y if tp_divides(x.shape[-2]) else shard(y, "fsdp", None, None)


def _split_heads(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  Under a context whose TP
    axis splits the projection's width but not the heads, the width is
    gathered first: a DTensor cannot view a split dim into dims the split
    does not follow (XLA reshards there on its own)."""
    if not tp_divides(heads):
        x = shard(x, "fsdp", None, None)
    return x.reshape(*x.shape[:-1], heads, hd)


def wcast(w: torch.Tensor, dt: torch.dtype, *entries) -> torch.Tensor:
    """A stored weight cast to the compute dtype *keeping its sharding*, so an
    FSDP all-gather at the use site moves the compute dtype's bytes."""
    return shard(w.to(dt), *entries)


# ------------------------------------------------------------------------- MLPs

def mlp_init(gen: torch.Generator | None, cfg: ModelConfig, d_ff: int | None = None,
             device=None) -> dict[str, torch.Tensor]:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    down = 1.0 / math.sqrt(Fd)
    if cfg.mlp == "swiglu":
        return {"w_gate": ninit(gen, (D, Fd), device=device),
                "w_up": ninit(gen, (D, Fd), device=device),
                "w_down": ninit(gen, (Fd, D), scale=down, device=device)}
    return {"w_up": ninit(gen, (D, Fd), device=device),
            "w_down": ninit(gen, (Fd, D), scale=down, device=device)}


def mlp_specs(cfg: ModelConfig) -> dict[str, tuple]:
    Fd = cfg.d_ff
    specs = {"w_up": ("fsdp", ("tp", Fd)), "w_down": (("tp", Fd), "fsdp")}
    if cfg.mlp == "swiglu":
        specs = {"w_gate": ("fsdp", ("tp", Fd)), **specs}
    return specs


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    # the input batch-split and whole in D: DTensor picks each product's
    # split op by op, and from a D-split input it would contract over TP
    # with the hidden width unsplit (ROADMAP §3)
    x = shard(x, "fsdp", None, None)
    if cfg.mlp == "swiglu":
        g = F.silu(shard(x @ wcast(p["w_gate"], dt, "fsdp", "tp"), "fsdp", None, "tp"))
        return (g * (x @ wcast(p["w_up"], dt, "fsdp", "tp"))) \
            @ wcast(p["w_down"], dt, "tp", "fsdp")
    h = shard(x @ wcast(p["w_up"], dt, "fsdp", "tp"), "fsdp", None, "tp")
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.square(F.relu(h)) if cfg.mlp == "relu2" else F.gelu(h, approximate="tanh")
    return h @ wcast(p["w_down"], dt, "tp", "fsdp")


# -------------------------------------------------------------------------- MoE

def moe_init(gen: torch.Generator | None, cfg: ModelConfig,
             device=None) -> dict[str, torch.Tensor]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ninit(gen, (D, E), device=device),
            "experts_gate": ninit(gen, (E, D, Fd), device=device),
            "experts_up": ninit(gen, (E, D, Fd), device=device),
            "experts_down": ninit(gen, (E, Fd, D), scale=1.0 / math.sqrt(Fd),
                                  device=device)}


def moe_specs(cfg: ModelConfig) -> dict[str, tuple]:
    E = cfg.n_experts
    return {"router": ("fsdp", None), "experts_gate": (("tp", E), "fsdp", None),
            "experts_up": (("tp", E), "fsdp", None),
            "experts_down": (("tp", E), None, "fsdp")}


def moe_route(p: Params, xg: torch.Tensor, cfg: ModelConfig):
    """The router over groups xg (G, g, D) -> (probs (G, g, E) f32, gate values
    and expert ids (G, g, k)).  Ties go to the lower expert id first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, gate_v[..., :cfg.top_k], gate_i[..., :cfg.top_k]


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes, as an equality with
    ``arange(n)``: ``F.one_hot`` takes another path of ops on each device
    (a value check and a scatter on the CPU), and the op counter must count
    the same on ``meta`` as on the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """GShard-style top-k dispatch with per-group capacity -> (y, aux loss).
    A token's slot in its expert's queue is its place in the group's
    (token, k) order; past ``cap`` it is dropped."""
    B, S, D = x.shape
    E = cfg.n_experts
    dt = x.dtype
    n = B * S
    g = min(cfg.moe_group_size, n)
    if n % g:
        raise ValueError(f"{n} tokens do not split into MoE groups of {g}")
    G = n // g
    cap = max(1, int(math.ceil(g * cfg.top_k * cfg.capacity_factor / E)))
    xg = shard(x.reshape(G, g, D), "fsdp", None, None)
    probs, gate_v, gate_i = moe_route(p, xg, cfg)
    gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)
    onehot = one_hot(gate_i, E)                                    # (G, g, k, E)
    slot_flat = onehot.reshape(G, -1, E)
    pos = (torch.cumsum(slot_flat, dim=1) - slot_flat).reshape(onehot.shape)
    keep = (pos < cap) & (onehot > 0)
    pos_c = torch.clamp(pos.long(), 0, cap - 1)
    cap_oh = one_hot(pos_c, cap) * keep[..., None]
    dispatch = cap_oh.sum(2)                                       # (G, g, E, cap)
    combine = (cap_oh * gate_v[..., None, None]).sum(2)            # (G, g, E, cap)
    xe = torch.einsum("Ggec,Ggd->eGcd", dispatch.to(dt), xg)       # (E, G, cap, D)
    xe = shard(xe, "tp", "fsdp", None, None)
    h = F.silu(torch.einsum("eGcd,edf->eGcf", xe,
                            wcast(p["experts_gate"], dt, "tp", "fsdp", None)))
    h = h * torch.einsum("eGcd,edf->eGcf", xe, wcast(p["experts_up"], dt, "tp", "fsdp", None))
    h = shard(h, "tp", "fsdp", None, None)
    ye = torch.einsum("eGcf,efd->eGcd", h, wcast(p["experts_down"], dt, "tp", None, "fsdp"))
    y = torch.einsum("Ggec,eGcd->Ggd", combine.to(dt), ye)
    return y.reshape(B, S, D), _load_balance_loss(probs, onehot)


def _load_balance_loss(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss."""
    E = probs.shape[-1]
    frac_tokens = onehot.sum(2).mean(dim=(0, 1))    # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    return E * torch.sum(frac_tokens * frac_probs)


# -------------------------------------------------------------------- embedding

VOCAB_PAD = 16  # the reference pads the vocab to a TP multiple; kept for its shapes


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def embed_init(gen: torch.Generator | None, cfg: ModelConfig,
               device=None) -> dict[str, torch.Tensor]:
    V, D = padded_vocab(cfg.vocab), cfg.d_model
    params = {"embedding": ninit(gen, (V, D), scale=1.0, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ninit(gen, (D, V), device=device)
    return params


def embed_specs(cfg: ModelConfig) -> dict[str, tuple]:
    V = padded_vocab(cfg.vocab)
    specs = {"embedding": (("tp", V), "fsdp")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", ("tp", V))
    return specs


def embed_lookup(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = p["embedding"].to(cfg.dtype)
    if tp_splits(table.shape[0]) and is_dtensor(table):
        x = _masked_rows(shard(table, "tp", None), tokens)
    else:
        x = table[tokens]
    return shard(x, *("fsdp",) + (None,) * (x.ndim - 1))


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    # the FSDP axis of the projection gathered before the product, the input
    # batch-split (ROADMAP §3): otherwise DTensor contracts over a split D
    # with every token on every device
    x = shard(x, "fsdp", None, None)
    logits = shard(x @ shard(w.to(x.dtype), None, "tp"), "fsdp", None, "tp")
    if logits.shape[-1] != cfg.vocab:  # mask the vocab padding, in the logits' dtype
        logits[..., cfg.vocab:].fill_(NEG_INF)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """The mean next-token loss in f32, with the z-loss term on the log
    partition function."""
    logits = logits.float()
    if tp_splits(logits.shape[-1]) and is_dtensor(logits):
        # vocab-sharded logits (ROADMAP §3): the log partition function and
        # the label's logit as sums over the split vocab, which reduce (B, S)
        # partial sums over the TP axis -- DTensor's logsumexp would gather
        # the vocab, and its rule for a gather fails there
        top = shard(logits.detach().amax(-1, keepdim=True), "fsdp", None, None)
        total = shard(torch.exp(logits - top).sum(-1, keepdim=True), "fsdp", None, None)
        lse = (top + torch.log(total))[..., 0]
        ll = _label_logit(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return shard(loss, "fsdp", None).mean()


def _local_ids(ids: torch.Tensor, n: int):
    """This device's view of token or label ids against its slice of ``n``
    vocab entries (the TP axis splits the vocab): the ids as a DTensor split
    like the batch, their local offsets into the slice, clamped, and whether
    each falls inside it."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = get_mesh()
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    ids = shard(ids, *("fsdp",) + (None,) * (ids.ndim - 1))
    off = mesh.get_local_rank("model") * n
    local = ids.to_local().long() - off
    return ids, local.clamp(0, n - 1), (local >= 0) & (local < n)


def _masked_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` from a table whose vocab the TP axis splits: each
    device reads the rows of its slice (zeros for the others) into its own
    slot of a (..., D, TP) tensor whose sum over the slots reduces over TP --
    the masked lookup a partitioner makes of a gather from a split dim
    (DTensor's own rules for it fail in the backward, ROADMAP §3)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    # the rows this device's tokens read: their gradient is a partial sum
    # over the axes that replicate the table
    loc = table.to_local(grad_placements=[Partial() if p.is_replicate() else p
                                          for p in table.placements])
    ids, idx, inside = _local_ids(tokens, loc.shape[0])
    x = (loc[idx] * inside[..., None].to(loc.dtype))[..., None]
    out = list(ids.placements)
    out[get_mesh().mesh_dim_names.index("model")] = Shard(x.ndim - 1)
    return DTensor.from_local(x, get_mesh(), out, run_check=False).sum(-1)


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each label's logit from vocab-split DTensor logits: each device reads
    the labels that fall in its vocab slice (zero for the others) into its
    own slot of a (B, S, TP) tensor whose sum over the slots reduces over the
    TP axis -- the masked lookup a partitioner makes of a gather from a split
    dimension."""
    from torch.distributed.tensor import DTensor

    logits = shard(logits, "fsdp", None, "tp")
    loc = logits.to_local()
    _, idx, inside = _local_ids(labels, loc.shape[-1])
    ll = (torch.gather(loc, -1, idx[..., None])[..., 0] * inside)[..., None]
    return DTensor.from_local(ll, get_mesh(), logits.placements, run_check=False).sum(-1)
