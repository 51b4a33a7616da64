"""Roofline terms of a step on the H100, the reference's ``roofline/analysis.py``.

Three terms per (arch x shape x mesh), in seconds:

    compute    = counted FLOPs    / (chips * peak_bf16)
    memory     = counted bytes    / (chips * hbm_bw)
    collective = collective bytes / (chips * link_bw)

The counts come from ``op_cost.analyze`` of the eager step (every aten op it
dispatches, the backward and a remat's recompute included), where the
reference reads XLA's compiled program.  The field names are the
reference's: ``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` hold the
counted op totals here, one device's: on the one-card mesh the step's own,
on a production mesh the program one device runs with the step placed as
DTensors (``split`` "counted"), whose collectives give the collective term.
A record may still say ``split`` "ideal" (the whole step divided by the
chips, collectives unknown: ``coll_bytes_per_chip`` None, ``t_collective``
None); the dry run wrote those before the mesh was ported.  The reference's
``collective_bytes`` parses HLO text and has no counterpart; its ring
factors are ``op_cost.ring_wire_bytes``.

Hardware constants: the NVIDIA H100 SXM5's (H100 Tensor Core GPU datasheet).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12   # H100 SXM5 dense BF16 tensor-core peak, 989.4 TFLOP/s (datasheet)
HBM_BW = 3.35e12      # H100 SXM5 HBM3 bandwidth, 3.35 TB/s (datasheet)
LINK_BW = 450e9       # NVLink 4: 900 GB/s total per GPU, 450 GB/s each direction (datasheet)
HBM_BYTES = 80e9      # H100 SXM5 memory, 80 GB HBM3 (datasheet)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_bytes_per_chip: float | None
    coll_breakdown: dict | str
    model_flops_total: float
    per_device_bytes: int
    useful_bytes_per_chip: float = 0.0  # argument+output buffers: a read-once/
                                        # write-once lower bound on HBM traffic
    split: str = "counted"              # "counted" (one device's program) | "ideal" (step / chips)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float | None:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / LINK_BW

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time = max of the known terms (perfect overlap)."""
        return max(self._terms().values())

    @property
    def bw_frac(self) -> float:
        """Useful-traffic fraction of the counted HBM bytes (decode cells live
        here: the roofline for one-token steps is bandwidth, not FLOPs)."""
        return min(1.0, self.useful_bytes_per_chip / max(self.hlo_bytes_per_chip, 1.0))

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / total counted FLOPs -- catches remat/dispatch/mask waste."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline achieved at the modeled step time:
        (useful FLOPs / chips / step_time) / peak."""
        useful_per_chip_rate = (self.model_flops_total / self.chips) \
            / max(self.step_time, 1e-12)
        return useful_per_chip_rate / PEAK_FLOPS

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 step_time=self.step_time,
                 useful_flops_frac=self.useful_flops_frac,
                 bw_frac=self.bw_frac,
                 roofline_frac=self.roofline_frac)
        return d


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N*B decode (active
    params for MoE) + attention term.  Enc-dec: the decoder only sees S/8 tokens
    (repro_torch.models.encdec.SRC_RATIO), so its params are weighted accordingly."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        # approximate enc/dec param split by layer counts (enc 2/5 of a dec
        # layer's params: no cross-attn): weight dec params by 1/8 token count
        frac_dec = 0.55
        n_active = n_active * ((1 - frac_dec) + frac_dec / 8)
    if kind == "train":
        tokens = B * S
        base = 6 * n_active * tokens
        attn = 12 * cfg.n_layers * cfg.n_heads * cfg.hd * S * S * B \
            if cfg.family not in ("ssm",) else 0
    elif kind == "prefill":
        tokens = B * S
        base = 2 * n_active * tokens
        attn = 4 * cfg.n_layers * cfg.n_heads * cfg.hd * S * S * B \
            if cfg.family not in ("ssm",) else 0
    else:  # decode: one token per sequence
        base = 2 * n_active * B
        attn = 4 * cfg.n_layers * cfg.n_heads * cfg.hd * S * B \
            if cfg.family not in ("ssm",) else 0
    if cfg.family == "hybrid":
        attn = attn / max(1, cfg.attn_every)  # shared block applied 1/k as often
    return float(base + attn)


def _ms(t: float | None) -> str:
    return "n/a" if t is None else f"{t * 1e3:.2f} ms"


def summarize(records: list[dict]) -> str:
    """Markdown table of ``Roofline.to_dict`` records."""
    hdr = ("| arch | shape | mesh | t_compute | t_memory | t_collective | "
           "bottleneck | useful/counted | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in records:
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_ms(r['t_compute'])} | {_ms(r['t_memory'])} "
            f"| {_ms(r['t_collective'])} | {r['bottleneck']} "
            f"| {r['useful_flops_frac'] * 100:.1f}% "
            f"| {r['roofline_frac'] * 100:.1f}% |")
    return hdr + "\n".join(rows)
