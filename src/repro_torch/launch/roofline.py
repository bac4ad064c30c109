"""Three-term roofline of one step (counterpart of
``repro.launch.roofline``).

Hardware rates live in :class:`HardwareSpec`; pick one by name through
:data:`KNOWN_HARDWARE` or let :func:`detect_hardware` read the card. The
port runs on one NVIDIA H100 (the ``h100`` entry, the default); the
reference's five entries stay, so that a roofline of the port can be put
beside the reference's. The rates are published peaks, not measured ones:
a roofline share is stated against the data sheet, with the card's power
limit beside it (the H100's rates assume its full 700 W).

FLOPs and bytes are per card. On one card no step moves bytes between
cards, so the collective term of the port's own rooflines is zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peak rates of one accelerator generation."""

    name: str
    peak_flops: float  # bf16 FLOP/s per chip
    hbm_bw: float      # HBM B/s per chip
    ici_bw: float      # B/s per interconnect link (1 link per transfer)


#: One NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates without
#: sparsity, at the full 700 W).
H100 = HardwareSpec(
    "h100",
    peak_flops=989e12,  # bf16 (and fp16) on the tensor cores, dense
    hbm_bw=3.35e12,     # HBM3, 80 GB
    ici_bw=25e9,        # one NVLink 4 link, one direction (18 links carry
                        # 900 GB/s in both directions together)
)

#: The H100's float32 rate outside the tensor cores (the same data sheet):
#: the bound of the kernels that compute in float32 on the CUDA cores.
H100_F32_FLOPS = 67e12

TPU_V5E = HardwareSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                       ici_bw=50e9)

#: Specs addressable by ``--hardware``: the H100 and the reference's five
#: (public per-chip peaks; ``cpu`` is a rough host stand-in that keeps
#: rooflines finite).
KNOWN_HARDWARE: Dict[str, HardwareSpec] = {
    "h100": H100,
    "tpu-v5e": TPU_V5E,
    "tpu-v4": HardwareSpec("tpu-v4", peak_flops=275e12, hbm_bw=1200e9,
                           ici_bw=50e9),
    "tpu-v5p": HardwareSpec("tpu-v5p", peak_flops=459e12, hbm_bw=2765e9,
                            ici_bw=100e9),
    "tpu-v6e": HardwareSpec("tpu-v6e", peak_flops=918e12, hbm_bw=1640e9,
                            ici_bw=100e9),
    "cpu": HardwareSpec("cpu", peak_flops=0.5e12, hbm_bw=50e9, ici_bw=10e9),
}


def detect_hardware(override: Optional[str] = None) -> HardwareSpec:
    """The :class:`HardwareSpec` of an explicit name, or of the CUDA card
    (``torch.cuda.get_device_name()``): a known name inside the card's
    name, the H100 for a card it does not recognise, ``cpu`` where there
    is no card. Unknown ``override`` names raise ``ValueError`` listing the
    known ones."""
    if override is not None:
        try:
            return KNOWN_HARDWARE[override]
        except KeyError:
            raise ValueError(
                f"unknown hardware {override!r} "
                f"(known: {sorted(KNOWN_HARDWARE)})") from None
    import torch
    if not torch.cuda.is_available():
        return KNOWN_HARDWARE["cpu"]
    kind = torch.cuda.get_device_name().lower()
    for name, spec in KNOWN_HARDWARE.items():
        if name in kind:
            return spec
    return H100


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_total: float  # 6*N*D (dense) / 6*N_active*D (MoE), all chips

    n_chips: int = 1
    spec: HardwareSpec = H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.spec.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / self.spec.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_chip / self.spec.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs: how much of the step's compute is
        'useful' (below 1: recompute or overhead; above 1: the count
        misses operations)."""
        total = self.flops_per_chip * self.n_chips
        if total <= 0:
            return None
        return self.model_flops_total / total

    def as_dict(self) -> Dict:
        return {
            "hardware": self.spec.name,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops_total": self.model_flops_total,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def aggregation_roofline(*, batch: int, n: int, d: int,
                         dtype_bytes: int = 4,
                         spec: Optional[HardwareSpec] = None,
                         n_chips: int = 1) -> Roofline:
    """Roofline of one batched robust-aggregation pass (the CWTM, median
    and pairdist kernels): ``batch`` lanes, each reducing an ``[n, d]``
    worker stack to ``[d]``.

    Bytes: one read of every worker stack plus one write of the result.
    FLOPs: the bitonic compare-exchange network
    (``kernels.cwtm.sort_network_compares``) at one min and one max a pair
    and coordinate, plus the trimmed-window reduction, an overcount of the
    median and pairdist passes. Wire bytes are zero: the pass is local to
    the card. These are the reference's counts; the bounds of the port's
    kernels take :func:`sorted_weight_work` and :func:`pairdist_work`
    (two operations a row of the weighted sum, not one)."""
    from repro_torch.kernels.cwtm import sort_network_compares
    n_pad = max(2, 1 << (n - 1).bit_length())
    bytes_moved = batch * (n * d + d) * dtype_bytes
    flops = batch * d * (2 * sort_network_compares(n_pad) + n)
    return Roofline(flops_per_chip=flops / n_chips,
                    hbm_bytes_per_chip=bytes_moved / n_chips,
                    wire_bytes_per_chip=0.0,
                    model_flops_total=flops,
                    n_chips=n_chips,
                    spec=spec if spec is not None else H100)


# --------------------------------------------------------------------------
# The port's kernels: the work of one call, ``(bytes, operations)``, each
# input read once and each output written once. Every bound of a kernel
# (``chip_smoke.py``) and the dry run's server round read these.
# --------------------------------------------------------------------------


def pairdist_work(b: int, n: int, d: int, itemsize: int) -> tuple:
    """``pairdist``: ``[b, n, d]`` in, ``[b, n, n]`` float32 out;
    ``n(n+1)/2`` multiply-adds a coordinate."""
    return b * n * d * itemsize + b * n * n * 4, b * d * n * (n + 1)


def sorted_weight_work(b: int, n: int, d: int, itemsize: int) -> tuple:
    """The sorted-rank kernel (CWTM and the median): ``[b, n, d]`` in,
    ``[b, d]`` out; the bitonic network at one min and one max a pair, and
    one multiply and one add a row of the weighted sum."""
    from repro_torch.kernels.cwtm.cwtm import n_pad_of, sort_network_compares
    return (b * n * d * itemsize + b * d * itemsize,
            b * d * (2 * sort_network_compares(n_pad_of(n)) + 2 * n))


def compress_work(n: int, kb: int, bs: int, itemsize: int,
                  n_ids: int) -> tuple:
    """``block_compress``: the ``kb`` selected blocks of each row read, the
    ``[n, kb * bs]`` payload written, ``n_ids`` int32 block ids read; one
    multiply a value."""
    pay = n * kb * bs
    return 2 * pay * itemsize + n_ids * 4, pay


def decompress_work(n: int, d: int, kb: int, bs: int, itemsize: int,
                    n_ids: int, n_slots: int) -> tuple:
    """``block_decompress``: the payload read, the dense ``[n, d]`` written,
    the ids and the ``n_slots`` int32 block-slot table read; no
    arithmetic."""
    return (n * kb * bs * itemsize + n * d * itemsize + n_slots * 4
            + n_ids * 4, 0)


def momentum_work(n: int, d: int, kb: int, bs: int, itemsize: int,
                  payload_itemsize: int, n_ids: int, f32_out: bool) -> tuple:
    """``momentum_scatter``: the ``[n, d]`` bank read and written, the
    payload and the ids read, the float32 ``[n, d]`` result written with
    ``f32_out``; a multiply and a fused add a value."""
    return (2 * n * d * itemsize + n * kb * bs * payload_itemsize
            + n_ids * 4 + (n * d * 4 if f32_out else 0), 2 * n * d)


def flash_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
               pairs: int, itemsize: int = 2) -> Dict[str, tuple]:
    """The flash kernels on ``q [b, sq, h, d]``, ``k, v [b, sk, kv, d]``
    of ``itemsize`` bytes (2: bf16; 4: the float32 kernels) with ``pairs``
    visible (query, key) pairs a head: the forward reads q, k, v and
    writes the output and the float32 log-sum-exp (two matmuls, 4
    operations a pair and lane); the backward reads them and the output's
    gradient and writes dq, dk and dv (2.5 times the forward's
    operations)."""
    q, kvn = b * sq * h * d, b * sk * kv * d
    io = (2 * q + 2 * kvn) * itemsize  # q and o, k and v
    lse = b * h * sq * 4
    fwd = 4 * b * h * d * pairs
    return {"flash_fwd": (io + lse, fwd),
            "flash_bwd": (io + (2 * q + 2 * kvn) * itemsize + lse,
                          2.5 * fwd)}


def bound_ms(work: tuple, ops_per_s: float) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time for ``work =
    (bytes, operations)`` on one H100, the larger of the bytes at its HBM
    rate and the operations at ``ops_per_s`` (:data:`H100_F32_FLOPS` for
    the kernels that compute in float32, ``H100.peak_flops`` on the
    tensor cores)."""
    nbytes, ops = work
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE); decode/prefill
# use 2 * N * D per generated/consumed token.
# --------------------------------------------------------------------------


def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count of the config (embeddings once; MoE counts
    every expert unless ``active_only``). Norms are left out: the built
    model's element count is a little larger."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    n = 0
    # embeddings + head
    if cfg.input_kind == "tokens":
        n += cfg.vocab_size * d
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        n += d * cfg.vocab_size

    def attn_params() -> int:
        if cfg.use_mla:
            qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            return (d * cfg.n_heads * qd
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    + cfg.kv_lora_rank * cfg.n_heads
                    * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + cfg.n_heads * cfg.v_head_dim * d)
        return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d)

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        return mult * d * ff

    def ssm_params() -> int:
        di = cfg.ssm_d_inner
        gn = cfg.ssm_n_groups * cfg.ssm_state
        h = cfg.ssm_n_heads
        return (d * (2 * di + 2 * gn + h) + cfg.ssm_conv_width * (di + 2 * gn)
                + di * d + 3 * h + di)

    fam = cfg.family
    if fam in ("dense", "audio"):
        n += L * (attn_params() + mlp_params(cfg.d_ff))
    elif fam == "moe":
        fk = cfg.first_k_dense
        n += fk * (attn_params() + mlp_params(cfg.d_ff))
        e = cfg.top_k if active_only else cfg.n_experts
        per_layer = attn_params() + e * mlp_params(cfg.d_ff) \
            + cfg.n_shared_experts * mlp_params(cfg.d_ff) + d * cfg.n_experts
        n += (L - fk) * per_layer
    elif fam == "ssm":
        n += L * ssm_params()
    elif fam == "hybrid":
        n += L * ssm_params()
        n += attn_params() + mlp_params(cfg.d_ff)  # ONE shared block
    elif fam == "vlm":
        g = L // cfg.cross_attn_every
        n_self = L - g
        n += n_self * (attn_params() + mlp_params(cfg.d_ff))
        n += g * (attn_params() + mlp_params(cfg.d_ff))  # cross layers
    return n


def model_flops(cfg, shape, active_only_params: Optional[int] = None) -> float:
    """6*N*D for training; 2*N*tokens for inference steps."""
    n_active = active_only_params if active_only_params is not None \
        else count_params(cfg, active_only=(cfg.family == "moe"))
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch
