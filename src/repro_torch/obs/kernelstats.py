"""Per-kernel-family dispatch stats + modeled FLOPs/HBM-bytes roofline.

Counterpart of ``repro/obs/kernelstats.py``. ``kernels/ops.py`` is the
single chokepoint every kernel (and its plain version) dispatches
through; this module is its flight recorder. Each dispatch records, per
kernel family: invocation count, output-element counts, and analytically
modeled FLOPs and device-memory bytes from the call's shapes, with the
reference's models for its 17 families and models of the port's own
five (the R draw of one unit and of a group, the draw's last stage,
the CSR step of one unit and of a group). The port runs
eagerly, so every dispatch is a call and ``traced_calls`` stays 0.

``roofline_table`` folds the accumulated totals against a hardware model
into a live roofline: arithmetic intensity, modeled compute/memory time,
and which wall each family sits against. The default model is an H100
SXM (``HW``): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores, NVIDIA's data sheet; ``int32_ops`` and ``popc_ops`` are
the CUDA C Programming Guide's 64 and 16 results an SM a clock at 132
SMs and the 1.98 GHz boost clock (the peaks ``chip_smoke.py`` bounds
its kernels with).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.registry import default_registry

__all__ = ["HW", "KernelStats", "model", "record", "get_kernel_stats",
           "set_kernel_stats", "roofline_table", "MODELS"]


@dataclass(frozen=True)
class HW:
    """Published peaks of one NVIDIA H100 SXM at its 700 W limit."""
    name: str = "H100 SXM"
    hbm_bw: float = 3.35e12                   # bytes/s
    peak_flops: float = 67e12                 # float32, CUDA cores
    int32_ops: float = 132 * 64 * 1.98e9      # int32 add/logic/shift
    popc_ops: float = 132 * 16 * 1.98e9       # popcounts


def _mask_bytes(n: int) -> int:
    """Bytes of a packed row-validity bitmask over ``n`` rows."""
    return 4 * ((n + 31) // 32)


def _m_coded_project(m, d, k, **_):
    return m * k, 2 * m * d * k, 4 * (m * d + d * k + m * k)


def _m_encode_fused(m, d, k, w, **_):
    return m * k, 2 * m * d * k, 4 * (m * d + d * k + m * w)


def _m_code_pack(m, k, w, **_):
    return m * k, m * k, 4 * (m * k + m * w)


def _m_pack_codes(m, k, w, **_):
    return m * k, m * k, 4 * (m * k + m * w)


def _m_collision_counts(q, n, k, **_):
    return q * n, q * n * k, 4 * (q * k + n * k + q * n)


def _m_packed_collision_counts(q, n, w, **_):
    # XOR + popcount-fold + accumulate per word pair ~ 3 word ops (the
    # reference's model: the function's work, whichever kernel runs). Its
    # bytes are the [Q, N] write, and they bind: 0.75 W word ops a byte
    # sits under the float32 ridge (20) up to W = 26, and the tensor-core
    # kernel of 1- and 2-bit codes (csrc/packed_counts.cu) is bound by
    # that write too
    return q * n, 3 * q * n * w, 4 * (q * w + n * w + q * n)


def _m_packed_topk(q, n, w, top_k, **_):
    return q * n, 3 * q * n * w, 4 * (q * w + n * w + 2 * q * top_k)


def _m_packed_topk_masked(q, n, w, top_k, **_):
    e, f, b = _m_packed_topk(q, n, w, top_k)
    return e, f, b + _mask_bytes(n)


def _m_packed_lut_topk(q, n, w, t, k, top_k, **_):
    # one table lookup + add per code field
    return q * n, 2 * q * n * k, 4 * (q * t + n * w + 2 * q * top_k)


def _m_packed_lut_topk_masked(q, n, w, t, k, top_k, **_):
    e, f, b = _m_packed_lut_topk(q, n, w, t, k, top_k)
    return e, f, b + _mask_bytes(n)


def _m_packed_lut_rerank(q, c, w, t, k, top_k, **_):
    return (q * c, 2 * q * c * k,
            4 * (q * t + q * c * w + 2 * q * top_k) + q * c)


def _m_fused_scored_topk(q, n, w, t, k, top_k, **_):
    # two corpus sweeps: counts twice (~3 word ops each), the k+1-bin
    # exceedance histogram in sweep A, LUT select+add per field in B
    return (q * top_k, q * n * (6 * w + 3 * k + 1),
            4 * (q * w + q * t + 2 * n * w + 2 * q * top_k))


def _m_fused_scored_topk_masked(q, n, w, t, k, top_k, **_):
    e, f, b = _m_fused_scored_topk(q, n, w, t, k, top_k)
    return e, f, b + 2 * _mask_bytes(n)


def _m_packed_linear_fwd(c, n, w, t, k, **_):
    return c * n, 2 * c * n * k, 4 * (c * t + n * w + c * n)


def _m_packed_linear_fwd_masked(c, n, w, t, k, **_):
    e, f, b = _m_packed_linear_fwd(c, n, w, t, k)
    return e, f, b + _mask_bytes(n)


def _m_packed_linear_bwd(c, n, w, t, k, **_):
    return c * n, 2 * c * n * k, 4 * (c * n + n * w + c * t)


def _m_packed_linear_bwd_masked(c, n, w, t, k, **_):
    e, f, b = _m_packed_linear_bwd(c, n, w, t, k)
    return e, f, b + _mask_bytes(n)


def _m_normal_unit(m, k, **_):
    # threefry (about 80 int32 ops) and XLA's erfinv (about 60 float ops)
    return m * k, 60 * m * k, 4 * m * k


def _m_normal_from_bits(m, k, **_):
    return m * k, 60 * m * k, 8 * m * k


def _m_csr_step(m, k, nnz, span, rb, **_):
    # one multiply and one add a (entry, projection); the entries' column
    # ids and values, and the units (span columns of rb bytes a value)
    # read once; the touched accumulator rows (at most one an entry) read
    # and written once
    rows = min(m, nnz)
    return rows * k, 2 * nnz * k, 8 * nnz + rb * span * k + 8 * rows * k


# family -> fn(**dims) -> (elements, flops, hbm_bytes); dims are the
# static shape parameters ops.py extracts at dispatch
MODELS = {
    "coded_project": _m_coded_project,
    "encode_fused": _m_encode_fused,
    "code_pack": _m_code_pack,
    "pack_codes": _m_pack_codes,
    "collision_counts": _m_collision_counts,
    "packed_collision_counts": _m_packed_collision_counts,
    "packed_topk": _m_packed_topk,
    "packed_topk_masked": _m_packed_topk_masked,
    "packed_lut_topk": _m_packed_lut_topk,
    "packed_lut_topk_masked": _m_packed_lut_topk_masked,
    "packed_lut_rerank": _m_packed_lut_rerank,
    "fused_scored_topk": _m_fused_scored_topk,
    "fused_scored_topk_masked": _m_fused_scored_topk_masked,
    "packed_linear_fwd": _m_packed_linear_fwd,
    "packed_linear_fwd_masked": _m_packed_linear_fwd_masked,
    "packed_linear_bwd": _m_packed_linear_bwd,
    "packed_linear_bwd_masked": _m_packed_linear_bwd_masked,
    "normal_unit": _m_normal_unit,
    "normal_unit_group": _m_normal_unit,
    "normal_from_bits": _m_normal_from_bits,
    "csr_unit_step": _m_csr_step,
    "csr_group_step": _m_csr_step,
}


def model(family: str, **dims):
    """(elements, flops, hbm_bytes) modeled for one dispatch of
    ``family`` at the given static dims; KeyError on unknown family."""
    return MODELS[family](**dims)


class KernelStats:
    """Accumulated per-family dispatch totals (a plain host dict)."""

    __slots__ = ("families",)

    def __init__(self):
        self.families: dict[str, dict] = {}

    def record(self, family: str, traced: bool = False, **dims):
        """Fold one dispatch of ``family`` at ``dims`` into the totals."""
        elements, flops, hbm = model(family, **dims)
        f = self.families.get(family)
        if f is None:
            f = self.families[family] = {
                "calls": 0, "traced_calls": 0, "elements": 0,
                "flops": 0, "hbm_bytes": 0}
        f["calls"] += 1
        f["traced_calls"] += 1 if traced else 0
        f["elements"] += elements
        f["flops"] += flops
        f["hbm_bytes"] += hbm

    def reset(self):
        """Drop all accumulated totals."""
        self.families.clear()

    def snapshot(self) -> dict:
        """Copy of the per-family totals."""
        return {k: dict(v) for k, v in self.families.items()}

    def roofline_table(self, hw=None) -> dict:
        """Per-family roofline terms against a hardware model.

        Adds to each family's totals: arithmetic ``intensity``
        (FLOPs/byte), modeled ``t_compute_s`` / ``t_memory_s``, the
        binding wall (``bound``), the modeled wall time ``t_model_s``
        (max of the two) and modeled ``elements_per_s`` at that wall.
        ``hw`` defaults to the H100 model ``HW()``.
        """
        if hw is None:
            hw = HW()
        out = {}
        for fam, f in self.families.items():
            t_c = f["flops"] / hw.peak_flops
            t_m = f["hbm_bytes"] / hw.hbm_bw
            t = max(t_c, t_m)
            out[fam] = dict(
                f, intensity=f["flops"] / max(f["hbm_bytes"], 1),
                t_compute_s=t_c, t_memory_s=t_m, t_model_s=t,
                bound="compute" if t_c >= t_m else "memory",
                elements_per_s=f["elements"] / t if t else 0.0)
        return out


_DEFAULT = KernelStats()


def get_kernel_stats() -> KernelStats:
    """The process-global kernel-stat accumulator."""
    return _DEFAULT


def set_kernel_stats(ks: KernelStats) -> KernelStats:
    """Swap the process-global accumulator; returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = ks
    return prev


def record(family: str, traced: bool = False, **dims):
    """Record one dispatch into the global accumulator — the hook
    ``kernels/ops.py`` calls — and append a point event to the flight
    recorder (so the per-request story includes which kernels fired and
    in what order). No-op while the default metrics registry is
    disabled (the one switch that silences all of repro_torch.obs)."""
    if default_registry().enabled:
        _DEFAULT.record(family, traced=traced, **dims)
        _flight().record_kernel(family, traced)


def _flight():
    # late-bound so a set_flight_recorder swap is always respected;
    # imported lazily to keep module import order flexible
    from repro_torch.obs.events import default_flight_recorder
    global _flight
    _flight = default_flight_recorder
    return default_flight_recorder()


def roofline_table(hw=None) -> dict:
    """Roofline view of the global accumulator (see the method)."""
    return _DEFAULT.roofline_table(hw)
