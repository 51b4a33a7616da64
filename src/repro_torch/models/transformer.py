"""Decoder-only transformer LM, dense, MoE and VLM families: the reference's
``models/transformer.py``.

An ``nn.Module`` per block (``Block``: its ``Attention`` and ``MLP`` or ``MoE``
weights and two norm scales) in an ``nn.ModuleList`` under ``Transformer``.
The reference stacks its layers and scans them; here each block holds its own
slice and the model loops over them.  ``train_loss`` runs each block under the
remat policy (``layers.remat``) and adds the MoE layers' summed aux loss; the
serving paths drop it.  The VLM's forward takes patch embeddings prepended to
the tokens' and (t, h, w) M-RoPE positions ``pos3``; without ``pos3`` (every
decode step) the text position drives all three streams.

Serving weights are stored once in ``cfg.dtype`` (norm scales in f32), which
gives the bits of the reference's per-use cast of its f32 weights.  Training
holds f32 weights that take gradients and still computes in ``cfg.dtype``
(``LM.trainable``; ``init(..., train=True)``).

The KV cache is the reference's ``{"k", "v", "len"}`` with ONE length for
every slot (``len`` a Python int here): ``decode_step`` writes all slots at
``pos = len`` and attends to ``len + 1`` positions.  A request's output
therefore depends on what is served beside it (ROADMAP §3 R3); the port keeps
that so that it gives the reference's results.  The cache's tensors are
updated in place, and the returned cache shares them.

``LM`` holds what every family's model shares (the embedding, the final norm,
the logits, ``device``, ``with_dtype``); ``rwkv.py``, ``zamba.py`` and
``encdec.py`` build on it and on ``Block``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding_ctx import shard

NORMS = ("norm1", "norm2")
FAMILIES = ("dense", "moe", "vlm")


def _require_transformer(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"the {cfg.family} family is not a transformer; get_model(cfg) "
                         "builds its own model")


class Attention(L.Weights):
    """wq, wk, wv, wo (and bq, bk, bv with ``qkv_bias``) in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class MLP(L.Weights):
    """w_gate (swiglu), w_up, w_down in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class MoE(L.Weights):
    """router, experts_gate, experts_up, experts_down in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class Embedding(L.Weights):
    """embedding (and lm_head unless tied) in ``cfg.dtype``, padded vocab."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__(params, cfg.dtype)


class Block(nn.Module):
    """One layer: pre-norm attention and MLP (or MoE) with residuals."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, params["attn"])
        self.mlp = (MoE if cfg.family == "moe" else MLP)(cfg, params["mlp"])
        self.norms = L.Weights({k: params[k] for k in NORMS})

    def tree(self) -> dict[str, Any]:
        return {"attn": self.attn.tree(), "mlp": self.mlp.tree(),
                **self.norms.tree()}

    def _ffn(self, x: torch.Tensor):
        """-> (the residual stream after the MLP or MoE, the MoE's aux loss or
        None)."""
        cfg = self.cfg
        x = shard(x, "fsdp", None, None)     # the residual reduced once (ROADMAP §3)
        h = L.rms_norm(x, self.norms["norm2"], cfg.norm_eps)
        if cfg.family == "moe":
            y, aux = L.moe_apply(self.mlp, h, cfg)
            return x + y, aux
        return x + L.mlp_apply(self.mlp, h, cfg), None

    def _attend(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                causal: bool):
        cfg = self.cfg
        B, S, _ = x.shape
        x = shard(x, "fsdp", None, None)
        h = L.rms_norm(x, self.norms["norm1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(self.attn, h, cfg)
        q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        attn = L.flash_attention(q, k, v, causal=causal)
        return x + L.merge_heads(attn) @ self.attn["wo"].to(x.dtype), k, v

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                causal: bool = True):
        """The reference's ``_layer_fwd`` over a whole sequence: returns the
        new residual stream and the rotated k and v."""
        x, k, v = self._attend(x, cos, sin, causal)
        return self._ffn(x)[0], k, v

    def train_fwd(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  causal: bool = True):
        """-> (the new residual stream, the MoE aux loss or None)."""
        return self._ffn(self._attend(x, cos, sin, causal)[0])

    def decode(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               kc: torch.Tensor, vc: torch.Tensor, pos: int) -> torch.Tensor:
        """One token per slot against this layer's cache ``kc``/``vc`` (B, S,
        Hkv, hd), written in place at ``pos``."""
        x = x + self_attend(self.attn, self.norms["norm1"], x, cos, sin, kc, vc, pos,
                            self.cfg)
        return self._ffn(x)[0]


def self_attend(attn: L.Params, norm: torch.Tensor, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, pos: int,
                cfg: ModelConfig) -> torch.Tensor:
    """A decode step's self-attention, projected: the token's k and v go into
    the cache in place at ``pos`` (as the reference's ``dynamic_update_slice``,
    a ``pos`` past the end writes the last row), then q attends to ``pos + 1``
    positions."""
    B = x.shape[0]
    h = L.rms_norm(x, norm, cfg.norm_eps)
    q, k, v = L.attention_qkv(attn, h, cfg)
    q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
    row = min(pos, kc.shape[1] - 1)
    kc[:, row] = k[:, 0].to(kc.dtype)
    vc[:, row] = v[:, 0].to(vc.dtype)
    out = L.attention_decode(q, kc, vc, pos + 1)
    return out.reshape(B, 1, -1) @ attn["wo"].to(x.dtype)


class LM(nn.Module):
    """What every family's model shares: the embedding, the final norm and
    the logits; ``tree()`` gives the weights back as the family's
    constructor takes them."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, params["embed"])
        self.final = L.Weights({"final_norm": params["final_norm"]})
        freqs = torch.from_numpy(L.rope_freqs(cfg.hd, cfg.rope_theta))
        self.register_buffer("freqs", freqs.to(self.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    @classmethod
    def trainable(cls, cfg: ModelConfig, params: Mapping[str, Any]) -> "LM":
        """``cls(cfg, params)`` as training holds it: every weight an f32
        parameter that takes gradients (the reference's f32 master weights),
        the compute still in ``cfg.dtype``, as the reference casts each weight
        where it is used."""
        model = cls(dataclasses.replace(cfg, dtype=torch.float32), params)
        for m in model.modules():
            if "cfg" in vars(m):
                m.cfg = cfg
        return model.requires_grad_(True)

    def tree(self) -> dict[str, Any]:
        """The parameters, nested as the family's constructor takes them."""
        raise NotImplementedError

    def with_dtype(self, dtype: torch.dtype) -> "LM":
        """This model's weights cast to ``dtype`` (what the reference keeps in
        f32 stays f32), under a config of that dtype: what the reference
        computes from the same f32 weights when its config says ``dtype``."""
        return type(self)(dataclasses.replace(self.cfg, dtype=dtype), self.tree())

    def _common_tree(self) -> dict[str, Any]:
        return {"embed": self.embed.tree(),
                "final_norm": self.final.tree()["final_norm"]}

    def _rope(self, positions: torch.Tensor):
        return L.rope_cos_sin(positions, self.freqs)

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        # pinned like each block's input, so that the head's gradient is
        # reduced here under a mesh context (ROADMAP §3)
        return L.rms_norm(shard(x, "fsdp", None, None), self.final["final_norm"],
                          self.cfg.norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.lm_logits(self.embed, x, self.cfg)


def check_layers(got: int, want: int, what: str = "layers") -> None:
    if got != want:
        raise ValueError(f"{got} {what} for a config of {want}")


class Transformer(LM):
    """The dense, MoE or VLM LM: embedding, ``blocks``, final norm, logits.

    ``params`` is the reference's tree with the layers as a list (or any
    iterable) of per-layer dicts: ``{"embed": {...}, "layers": [{"attn",
    "mlp", "norm1", "norm2"}, ...], "final_norm": ...}``; weights are stored in
    ``cfg.dtype``, norm scales f32."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, Any]):
        _require_transformer(cfg)
        super().__init__(cfg, params)
        self.blocks = nn.ModuleList(Block(cfg, lp) for lp in params["layers"])
        check_layers(len(self.blocks), cfg.n_layers)

    def tree(self) -> dict[str, Any]:
        return {**self._common_tree(), "layers": [b.tree() for b in self.blocks]}

    def _embed(self, tokens: torch.Tensor, positions, pos3, prefix_embeds):
        """Token embeddings after the VLM's patch prefix, and the rotation
        tables of their positions."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        return x, self._tables(positions, pos3)

    def _tables(self, positions: torch.Tensor, pos3: torch.Tensor | None):
        cfg = self.cfg
        if not cfg.mrope:
            return self._rope(positions)
        if pos3 is None:
            pos3 = positions[:, None, :].expand(positions.shape[0], 3, positions.shape[1])
        return L.mrope_cos_sin(pos3, self.freqs, cfg.mrope_sections)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None,
                pos3: torch.Tensor | None = None,
                prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """-> the final-normed hidden states (B, S, D), S counting the prefix."""
        x, (cos, sin) = self._embed(tokens, positions, pos3, prefix_embeds)
        for blk in self.blocks:
            x, _, _ = blk(x, cos, sin)
        return self._finish(x)

    def train_loss(self, batch: Mapping[str, torch.Tensor], remat=None) -> torch.Tensor:
        """The reference's ``train_loss``: the next-token loss over the text
        positions (the VLM's patch prefix sliced off before the logits) plus
        0.01 x the MoE layers' summed aux loss; each block under ``remat``."""
        prefix = batch.get("patch_embeds")
        x, (cos, sin) = self._embed(batch["tokens"], None, batch.get("pos3"), prefix)
        aux = None
        for blk in self.blocks:
            x, a = L.remat(remat, blk.train_fwd, x, cos, sin)
            if a is not None:
                aux = a if aux is None else aux + a
        x = self._finish(x)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]
        loss = L.cross_entropy(self.logits(x), batch["labels"])
        return loss if aux is None else loss + 0.01 * aux

    def prefill(self, tokens: torch.Tensor, cache: dict, positions: torch.Tensor | None = None,
                pos3: torch.Tensor | None = None, prefix_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the full prompt (after the patch prefix, if any), fill the
        cache from position 0, return the logits of the last position and the
        cache with ``len`` = S."""
        x, (cos, sin) = self._embed(tokens, positions, pos3, prefix_embeds)
        S = x.shape[1]
        if S > cache["k"].shape[2]:
            raise ValueError(f"a {S}-token prompt does not fit a {cache['k'].shape[2]}-row "
                             "cache")
        for i, blk in enumerate(self.blocks):
            x, k, v = blk(x, cos, sin)
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        logits = self.logits(self._finish(x)[:, -1:])
        return logits, {"k": cache["k"], "v": cache["v"], "len": S}

    def decode_step(self, token: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """One new token per slot against the cache.  token: (B, 1) int."""
        B = token.shape[0]
        pos = int(cache["len"])
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=token.device)
        x = L.embed_lookup(self.embed, token, self.cfg)
        cos, sin = self._tables(positions, None)
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cos, sin, cache["k"][i], cache["v"][i], pos)
        logits = self.logits(self._finish(x))
        return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}


# ------------------------------------------------------------------------ params

def layer_init(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    mlp = L.moe_init if cfg.family == "moe" else L.mlp_init
    return {"attn": L.attention_init(gen, cfg, device=device),
            "mlp": mlp(gen, cfg, device=device),
            "norm1": L.oinit((cfg.d_model,), device), "norm2": L.oinit((cfg.d_model,), device)}


def layer_specs(cfg: ModelConfig) -> dict:
    """The logical sharding specs of one layer's weights (``layer_init``'s)."""
    mlp = L.moe_specs if cfg.family == "moe" else L.mlp_specs
    return {"attn": L.attention_specs(cfg), "mlp": mlp(cfg),
            "norm1": (None,), "norm2": (None,)}


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's logical specs of the param tree, the layers under a
    ``("stacked", ...)`` marker (one leading layer dimension)."""
    _require_transformer(cfg)
    return {"embed": L.embed_specs(cfg), "layers": ("stacked", layer_specs(cfg)),
            "final_norm": (None,)}


def init(cfg: ModelConfig, generator: torch.Generator | None = None,
         device=None, train: bool = False) -> Transformer:
    """A randomly initialised ``Transformer`` with the reference's shapes and
    scales: f32 draws from ``generator`` on ``device`` (the card unless
    given), stored in ``cfg.dtype`` -- or, with ``train``, kept as the f32
    weights training updates (``LM.trainable``).  The layers are drawn one at
    a time as the model stores them, so the f32 draws of one layer are alive
    at once."""
    _require_transformer(cfg)
    device = L.resolve_device(device)
    params = {"embed": L.embed_init(generator, cfg, device=device),
              "layers": (layer_init(generator, cfg, device) for _ in range(cfg.n_layers)),
              "final_norm": L.oinit((cfg.d_model,), device)}
    return (Transformer.trainable if train else Transformer)(cfg, params)


# ----------------------------------------------------------------------- serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    dtype = dtype or cfg.dtype
    device = L.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def cache_specs(cfg: ModelConfig, tp_size: int = 16) -> dict:
    """Logical partition specs for the KV cache.

    Heads shard over tp when divisible; otherwise the *sequence* dim does --
    decode attention contracts over S, so a partitioner reduces partial sums
    instead of replicating a multi-GB cache per chip."""
    if cfg.n_kv_heads % tp_size == 0:
        kv = (None, "fsdp", None, "tp", None)
    else:
        kv = (None, "fsdp", "tp", None, None)
    return {"k": kv, "v": kv, "len": ()}
