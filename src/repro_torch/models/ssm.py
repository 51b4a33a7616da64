"""Attention-free / hybrid families: RWKV6 ("Finch") and Mamba2 (for Zamba2),
the reference's ``models/ssm.py``.

Both use the reference's *chunked* linear-recurrence formulation for
prefill -- quadratic only within a chunk (``ssm_chunk``), with the state
carried from chunk to chunk (a Python loop here, its ``lax.scan`` there) --
and a decode step is the same code over one token.  All recurrence math runs
in f32.  Training differentiates through the chunk loops with autograd: no
tensor is written in place once it is computed.

The decay products keep the reference's factorisation: the pairwise decay
exp(cum_t - cum_s) is exp(cum_t) * exp(min(-cum_s, 60)).  cum is
non-increasing, so the first factor only underflows (to a correct 0); the
clamp only perturbs terms whose first factor already vanished.

A layer's weights are a ``Weights`` module (``RWKVLayer``, ``MambaLayer``)
stored in ``cfg.dtype``, with the tensors the reference reads in f32 (norm
scales, ``w0``, ``u``, ``A_log``, ``D_skip``, ``dt_bias``) kept in f32.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding_ctx import shard

_CLAMP = 60.0
RWKV_LORA_RANK = 64


def _chunk(x: torch.Tensor, c: int) -> torch.Tensor:  # (B, S, ...) -> (B, nc, c, ...)
    B, S = x.shape[:2]
    return x.reshape(B, S // c, c, *x.shape[2:])


def _chunk_len(S: int, chunk: int) -> int:
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"a {S}-token segment does not split into chunks of {c}")
    return c


# =============================================================== RWKV6 (Finch)

class RWKVLayer(L.Weights):
    """One RWKV6 layer's weights: time mix, decay LoRA, bonus, channel mix."""

    KEEP = frozenset({"w0", "u", "ln_x", "norm1", "norm2"})

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype, self.KEEP)


def rwkv_layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    r = RWKV_LORA_RANK
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=device)
    return {
        "wr": L.ninit(gen, (D, D), device=device), "wk": L.ninit(gen, (D, D), device=device),
        "wv": L.ninit(gen, (D, D), device=device), "wg": L.ninit(gen, (D, D), device=device),
        "wo": L.ninit(gen, (D, D), device=device),
        "w0": full((D,), -1.0),                                    # base decay
        "w_lora_a": L.ninit(gen, (D, r), device=device),
        "w_lora_b": L.zinit((r, D), device),
        "u": L.ninit(gen, (H, hd), scale=0.5, device=device),     # bonus
        "mix": full((5, D), 0.5),                                  # r/k/v/w/g token shift
        "ln_x": L.oinit((D,), device),
        "cm_wk": L.ninit(gen, (D, Fd), device=device),
        "cm_wv": L.ninit(gen, (Fd, D), scale=1 / math.sqrt(Fd), device=device),
        "cm_wr": L.ninit(gen, (D, D), device=device),
        "cm_mix": full((2, D), 0.5),
        "norm1": L.oinit((D,), device), "norm2": L.oinit((D,), device),
    }


def rwkv_layer_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """The logical sharding spec of each of ``rwkv_layer_init``'s weights."""
    D, Fd, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    return {
        "wr": ("fsdp", ("tp", D)), "wk": ("fsdp", ("tp", D)),
        "wv": ("fsdp", ("tp", D)), "wg": ("fsdp", ("tp", D)),
        "wo": (("tp", D), "fsdp"),
        "w0": (("tp", D),), "w_lora_a": ("fsdp", None), "w_lora_b": (None, ("tp", D)),
        "u": (("tp", H), None), "mix": (None, None), "ln_x": (None,),
        "cm_wk": ("fsdp", ("tp", Fd)), "cm_wv": (("tp", Fd), "fsdp"),
        "cm_wr": ("fsdp", ("tp", D)), "cm_mix": (None, None),
        "norm1": (None,), "norm2": (None,),
    }


def _token_shift(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); x_last: (B, D) hidden from the previous segment."""
    return torch.cat([x_last[:, None], x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """r/k/v/logw: (B, S, H, hd) f32 (logw <= 0); u: (H, hd); s0: (B, H, hd, hd).
    Returns (y (B, S, H, hd), s_end)."""
    B, S, H, hd = r.shape
    c = _chunk_len(S, chunk)
    rc, kc, vc, wc = (shard(_chunk(t, c).transpose(2, 3), "fsdp", None, "tp", None, None)
                      for t in (r, k, v, logw))
    # shapes now (B, nc, H, c, hd)
    t_idx = torch.arange(c, device=r.device)
    mask = (t_idx[:, None] > t_idx[None, :]).float()
    s, ys = s0, []
    for i in range(S // c):
        rb, kb, vb, wb = rc[:, i], kc[:, i], vc[:, i], wc[:, i]     # (B, H, c, hd)
        cum = torch.cumsum(wb, dim=2)            # inclusive
        cum_ex = cum - wb                        # exclusive
        a = rb * torch.exp(cum_ex)
        b = kb * torch.exp(torch.clamp(-cum, max=_CLAMP))
        scores = torch.einsum("bhti,bhsi->bhts", a, b)
        y = torch.einsum("bhts,bhsj->bhtj", scores * mask, vb)
        diag = torch.sum(rb * u[None, :, None, :] * kb, dim=-1, keepdim=True)
        y = y + diag * vb
        y = y + torch.einsum("bhti,bhij->bhtj", a, s)
        bs = b * torch.exp(cum[:, :, -1:, :])
        s = torch.exp(cum[:, :, -1, :])[..., None] * s \
            + torch.einsum("bhsi,bhsj->bhij", bs, vb)
        ys.append(y)
    y = torch.stack(ys, dim=1)                   # (B, nc, H, c, hd)
    return y.transpose(2, 3).reshape(B, S, H, hd), s


def rwkv_layer_fwd(cfg: ModelConfig, lp: L.Params, x: torch.Tensor, state=None):
    """x: (B, S, D).  state (decode/stream): dict with tm_last, cm_last, wkv;
    returns (x, the layer's new state)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, D // cfg.n_heads
    dt = x.dtype
    tm_last = state["tm_last"] if state else torch.zeros((B, D), dtype=dt, device=x.device)
    cm_last = state["cm_last"] if state else torch.zeros((B, D), dtype=dt, device=x.device)
    s0 = state["wkv"] if state else torch.zeros((B, H, hd, hd), device=x.device)

    # ---- time mix ----
    x = shard(x, "fsdp", None, None)
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    prev = _token_shift(h, tm_last)
    mix = lp["mix"].to(dt)

    def mx(i):
        return h * mix[i] + prev * (1 - mix[i])

    r = (mx(0) @ lp["wr"].to(dt)).reshape(B, S, H, hd)
    k = (mx(1) @ lp["wk"].to(dt)).reshape(B, S, H, hd)
    v = (mx(2) @ lp["wv"].to(dt)).reshape(B, S, H, hd)
    g = mx(4) @ lp["wg"].to(dt)
    # data-dependent decay (the Finch contribution)
    lora = torch.tanh(mx(3) @ lp["w_lora_a"].to(dt)) @ lp["w_lora_b"].to(dt)
    logw = -torch.exp(lp["w0"].float() + lora.float()).reshape(B, S, H, hd)
    y, s_end = _wkv_chunked(r.float(), k.float(), v.float(), logw, lp["u"].float(), s0,
                            cfg.ssm_chunk)
    y = y.reshape(B, S, D).to(dt)
    y = L.rms_norm(y, lp["ln_x"], cfg.norm_eps) * F.silu(g)
    x = x + y @ lp["wo"].to(dt)
    tm_last_new = h[:, -1]

    # ---- channel mix ----
    h2 = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    prev2 = _token_shift(h2, cm_last)
    cmix = lp["cm_mix"].to(dt)
    xk = h2 * cmix[0] + prev2 * (1 - cmix[0])
    xr = h2 * cmix[1] + prev2 * (1 - cmix[1])
    kk = torch.square(F.relu(xk @ lp["cm_wk"].to(dt)))
    out = torch.sigmoid(xr @ lp["cm_wr"].to(dt)) * (kk @ lp["cm_wv"].to(dt))
    x = x + out
    return x, {"tm_last": tm_last_new, "cm_last": h2[:, -1], "wkv": s_end}


# ============================================================== Mamba2 (SSD)

class MambaLayer(L.Weights):
    """One Mamba2 layer's weights: projections, conv, decay, skip, norms."""

    KEEP = frozenset({"A_log", "D_skip", "dt_bias", "ssm_norm", "norm"})

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype, self.KEEP)


def mamba_layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    D = cfg.d_model
    d_in = 2 * D
    H, N = cfg.ssm_heads, cfg.ssm_state
    return {
        "w_z": L.ninit(gen, (D, d_in), device=device),
        "w_x": L.ninit(gen, (D, d_in), device=device),
        "w_B": L.ninit(gen, (D, N), device=device), "w_C": L.ninit(gen, (D, N), device=device),
        "w_dt": L.ninit(gen, (D, H), device=device),
        "conv_w": L.ninit(gen, (4, d_in), scale=0.5, device=device),
        "A_log": L.zinit((H,), device),
        "D_skip": L.oinit((H,), device),
        "dt_bias": L.zinit((H,), device),
        "ssm_norm": L.oinit((d_in,), device),
        "w_out": L.ninit(gen, (d_in, D), scale=1 / math.sqrt(d_in), device=device),
        "norm": L.oinit((D,), device),
    }


def mamba_layer_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """The logical sharding spec of each of ``mamba_layer_init``'s weights."""
    d_in, H = 2 * cfg.d_model, cfg.ssm_heads
    return {
        "w_z": ("fsdp", ("tp", d_in)), "w_x": ("fsdp", ("tp", d_in)),
        "w_B": ("fsdp", None), "w_C": ("fsdp", None),
        "w_dt": ("fsdp", ("tp", H)),
        "conv_w": (None, ("tp", d_in)),
        "A_log": (("tp", H),), "D_skip": (("tp", H),), "dt_bias": (("tp", H),),
        "ssm_norm": (None,), "w_out": (("tp", d_in), "fsdp"),
        "norm": (None,),
    }


def _ssd_chunked(x, Bm, Cm, la, h0, chunk: int):
    """x: (B,S,H,P); Bm/Cm: (B,S,N); la: (B,S,H) log-decay*dt (<=0, already includes
    dt); x is already dt-scaled.  h0: (B,H,P,N).  Returns (y, h_end)."""
    B, S, H, P = x.shape
    c = _chunk_len(S, chunk)
    xc = _chunk(x, c).transpose(2, 3)            # (B,nc,H,c,P)
    Bc = _chunk(Bm, c)                           # (B,nc,c,N)
    Cc = _chunk(Cm, c)
    lc = _chunk(la, c).transpose(2, 3)           # (B,nc,H,c)
    t_idx = torch.arange(c, device=x.device)
    mask = t_idx[:, None] >= t_idx[None, :]
    h, ys = h0, []
    for i in range(S // c):
        xb, Bb, Cb, lb = xc[:, i], Bc[:, i], Cc[:, i], lc[:, i]
        cum = torch.cumsum(lb, dim=2)            # inclusive
        dplus = torch.exp(cum)                   # (B,H,c)
        dminus = torch.exp(torch.clamp(-cum, max=_CLAMP))
        cb = torch.einsum("btn,bsn->bts", Cb, Bb)  # (B,c,c)
        scores = cb[:, None] * dplus[..., :, None] * dminus[..., None, :]
        scores = torch.where(mask[None, None], scores, 0.0)
        y = torch.einsum("bhts,bhsp->bhtp", scores, xb)
        # contribution of the carried state
        y = y + torch.einsum("btn,bhpn->bhtp", Cb, h) * dplus[..., None]
        # new state
        xb_dec = xb * (dminus * torch.exp(cum[:, :, -1:]))[..., None]
        h = torch.exp(cum[:, :, -1])[..., None, None] * h \
            + torch.einsum("bhsp,bsn->bhpn", xb_dec, Bb)
        ys.append(y)
    y = torch.stack(ys, dim=1)                   # (B,nc,H,c,P)
    return y.transpose(2, 3).reshape(B, S, H, P), h


def mamba_layer_fwd(cfg: ModelConfig, lp: L.Params, x: torch.Tensor, state=None):
    """Mamba2 block.  state: {"conv": (B,3,d_in), "ssd": (B,H,P,N)}; returns
    (x, the layer's new state)."""
    B, S, D = x.shape
    d_in = 2 * D
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = d_in // H
    dt_ = x.dtype
    x = shard(x, "fsdp", None, None)
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    z = shard(h @ lp["w_z"].to(dt_), "fsdp", None, "tp")
    xi = shard(h @ lp["w_x"].to(dt_), "fsdp", None, "tp")
    conv_state = state["conv"] if state else torch.zeros((B, 3, d_in), dtype=dt_,
                                                         device=x.device)
    xi_pad = torch.cat([conv_state, xi], dim=1)
    # depthwise causal conv, kernel 4
    conv_w = lp["conv_w"].to(dt_)
    xi = sum(xi_pad[:, 3 - j:3 - j + S] * conv_w[3 - j] for j in range(4))
    xi = F.silu(xi)
    new_conv = xi_pad[:, S:S + 3]  # last 3 pre-activation inputs
    Bm = (h @ lp["w_B"].to(dt_)).float()
    Cm = (h @ lp["w_C"].to(dt_)).float()
    dtr = (h @ lp["w_dt"].to(dt_)).float()
    dt_act = F.softplus(dtr + lp["dt_bias"])                 # (B,S,H)
    la = -torch.exp(lp["A_log"]) * dt_act                    # (B,S,H) log decay
    xh = xi.reshape(B, S, H, P).float()
    x_scaled = xh * dt_act[..., None]
    h0 = state["ssd"] if state else torch.zeros((B, H, P, N), device=x.device)
    y, h_end = _ssd_chunked(x_scaled, Bm, Cm, la, h0, cfg.ssm_chunk)
    y = y + lp["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, d_in).to(dt_)
    y = L.rms_norm(y * F.silu(z), lp["ssm_norm"], cfg.norm_eps)
    out = y @ lp["w_out"].to(dt_)
    return x + out, {"conv": new_conv, "ssd": h_end}
