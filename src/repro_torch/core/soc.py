"""DSSoC hardware model for the DAS reproduction.

The paper's DSSoC (Section IV-A): Arm big.LITTLE (4+4 cores) plus dedicated
accelerators — 4x FFT, 4x FIR, 1x FEC, 2x SAP (systolic array processor) —
19 PEs total, mesh NoC.

Exact DS3 task profiles are not published in the paper; the tables below are
synthesized to match the paper's premises (accelerated tasks run 1-2 orders of
magnitude faster on their accelerator than on general-purpose cores; LITTLE is
the energy-efficient CPU; big is the fast CPU). All times are microseconds,
power in watts, energy in microjoules. See DESIGN.md, "Hardware model
calibration".
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ----------------------------------------------------------------------------
# Clusters and PEs
# ----------------------------------------------------------------------------
CLUSTER_NAMES = ("big", "little", "fft", "fir", "fec", "sap")
N_CLUSTERS = len(CLUSTER_NAMES)
BIG, LITTLE, FFT_ACC, FIR_ACC, FEC_ACC, SAP_ACC = range(N_CLUSTERS)

# PEs per cluster: 4 big + 4 LITTLE + 4 FFT + 4 FIR + 1 FEC + 2 SAP = 19.
PES_PER_CLUSTER = (4, 4, 4, 4, 1, 2)
N_PES = sum(PES_PER_CLUSTER)  # 19

# pe -> cluster map
PE_CLUSTER = np.concatenate(
    [np.full(n, c, dtype=np.int32) for c, n in enumerate(PES_PER_CLUSTER)]
)
# first PE index of each cluster
CLUSTER_PE_START = np.cumsum((0,) + PES_PER_CLUSTER[:-1]).astype(np.int32)
# (cluster, pe) membership mask, shape [N_CLUSTERS, N_PES]
CLUSTER_PE_MASK = np.stack(
    [PE_CLUSTER == c for c in range(N_CLUSTERS)]
).astype(np.bool_)

# ----------------------------------------------------------------------------
# Task types (the domain kernel vocabulary: wireless comms + radar)
# ----------------------------------------------------------------------------
TASK_TYPE_NAMES = (
    "scrambler",     # 0  CPU-only
    "interleaver",   # 1  CPU-only
    "qpsk_mod",      # 2  CPU-only
    "pilot_insert",  # 3  CPU-only
    "fft",           # 4  FFT accelerator
    "ifft",          # 5  FFT accelerator
    "fir",           # 6  FIR accelerator
    "fec_enc",       # 7  FEC accelerator
    "fec_dec",       # 8  FEC accelerator (viterbi)
    "matmul",        # 9  systolic array (SAP)
    "demod",         # 10 CPU-only
    "sync",          # 11 CPU-only
)
N_TASK_TYPES = len(TASK_TYPE_NAMES)

_INF = np.float32(np.inf)

# exec time (us) per [task_type, cluster]; inf = cluster cannot run the type.
# CPUs (big, LITTLE) can run everything. Calibration (see DESIGN.md):
# accelerated kernels are sub-microsecond on their accelerator (the paper's
# "order of nanoseconds" premise), 30-80x slower on CPUs; the small
# control-plane tasks are near-parity between big and LITTLE (so the
# energy-efficient LITTLE placement is also close to time-optimal at low
# load, as in the paper where LUT ~= ETF-ideal at low rates), while heavy
# kernels are ~1.6x slower on LITTLE.
# Control-plane kernels (sub-us, memory/IO-bound) run at time-parity on big
# and LITTLE (LITTLE wins on energy only); compute-bound kernels are ~1.6x
# slower on LITTLE. This mirrors the paper's low-rate regime where the
# energy-optimal (LUT) placement is also time-near-optimal.
EXEC_TIME = np.array(
    #  big    little  fft    fir    fec    sap
    [[ 0.45,   0.45, _INF,  _INF,  _INF,  _INF],   # scrambler
     [ 0.55,   0.55, _INF,  _INF,  _INF,  _INF],   # interleaver
     [ 0.70,   0.70, _INF,  _INF,  _INF,  _INF],   # qpsk_mod
     [ 0.35,   0.35, _INF,  _INF,  _INF,  _INF],   # pilot_insert
     [ 2.00,   3.20,  0.10, _INF,  _INF,  _INF],   # fft
     [ 2.00,   3.20,  0.10, _INF,  _INF,  _INF],   # ifft
     [ 1.40,   2.20, _INF,   0.07, _INF,  _INF],   # fir
     [ 2.80,   4.40, _INF,  _INF,   0.35, _INF],   # fec_enc
     [ 4.40,   7.00, _INF,  _INF,   0.55, _INF],   # fec_dec (viterbi)
     [ 3.00,   4.80, _INF,  _INF,  _INF,   0.30],  # matmul (systolic)
     [ 0.75,   0.75, _INF,  _INF,  _INF,  _INF],   # demod
     [ 0.90,   0.90, _INF,  _INF,  _INF,  _INF]],  # sync
    dtype=np.float32,
)

# active power (W) per cluster while executing a task
CLUSTER_POWER = np.array([1.8, 0.45, 0.45, 0.40, 0.50, 0.90], dtype=np.float32)

# energy (uJ) per [task_type, cluster] = exec_time * power
TASK_ENERGY = np.where(
    np.isfinite(EXEC_TIME), EXEC_TIME * CLUSTER_POWER[None, :], _INF
).astype(np.float32)

# ----------------------------------------------------------------------------
# LUT (fast scheduler) table: most energy-efficient cluster per task type.
# The paper: "The LUT stores the most energy-efficient processor in the target
# system for each known task"; unknown tasks -> next available CPU core.
# ----------------------------------------------------------------------------
LUT_CLUSTER = np.argmin(TASK_ENERGY, axis=1).astype(np.int32)

# ----------------------------------------------------------------------------
# NoC communication model: crossing clusters costs data_kb * US_PER_KB.
# Same-cluster communication is free (shared scratchpad / L2).
# ----------------------------------------------------------------------------
US_PER_KB = np.float32(0.02)  # ~50 GB/s effective NoC bandwidth

# ----------------------------------------------------------------------------
# Scheduler overhead models (Section III-C / IV-C of the paper)
# ----------------------------------------------------------------------------
# Fast (LUT) scheduler: ~7.2 cycles = 6 ns on A53 @1.2GHz, 2.3 nJ.
LUT_LATENCY_US = np.float32(0.006)
LUT_ENERGY_UJ = np.float32(0.0023)
# DAS preselection classifier: 13 ns in the background (zero critical-path
# latency), ~1.9 nJ per refresh -> DAS fast-path total 4.2 nJ (paper).
DAS_CLS_ENERGY_UJ = np.float32(0.0019)
# Slow (ETF) scheduler: quadratic in the ready-queue length n (the paper fits
# a quadratic to ZCU102 measurements; constants chosen so that light queues
# cost tens of ns and DAS's heavy-load average lands near 65 ns / 27.2 nJ).
ETF_LAT_C0 = np.float32(0.040)    # us
ETF_LAT_C1 = np.float32(0.0035)   # us per ready task
ETF_LAT_C2 = np.float32(0.0003)   # us per ready task^2
SCHED_POWER_W = np.float32(0.42)  # A53 core power while scheduling


def etf_latency_us(n_ready) -> np.ndarray:
    """Quadratic ETF decision latency model (numpy or torch, vectorized)."""
    n = n_ready
    return ETF_LAT_C0 + ETF_LAT_C1 * n + ETF_LAT_C2 * n * n


# Largest ready-queue length the simulator can hold (`simulator.R_MAX`).
ETF_LAT_MAX_N = 16


def _etf_latency_table() -> np.ndarray:
    """`etf_latency_us(n)` for n = 0..ETF_LAT_MAX_N as the JAX reference
    evaluates it under `jit` on the CPU, where XLA contracts the
    polynomial into `fma(c2*n, n, fma(c1, n, c0))`.

    Unfused float32 evaluation differs by one ULP at n = 7 and n = 15,
    and the latency sets when a decision completes, so one ULP can move
    a schedule. A float32 product is exact in float64, so each FMA is the
    exact product plus the addend, rounded once to float32.
    """
    c0, c1, c2 = ETF_LAT_C0, ETF_LAT_C1, ETF_LAT_C2
    out = np.empty(ETF_LAT_MAX_N + 1, np.float32)
    for n in range(ETF_LAT_MAX_N + 1):
        nf = np.float32(n)
        inner = np.float32(np.float64(c1) * np.float64(nf) + np.float64(c0))
        c2n = np.float32(c2 * nf)
        out[n] = np.float32(np.float64(c2n) * np.float64(nf)
                            + np.float64(inner))
    return out


# [ETF_LAT_MAX_N + 1] f32: the simulator looks the latency up by ready count
ETF_LAT_TABLE = _etf_latency_table()


@dataclasses.dataclass(frozen=True)
class SoCConfig:
    """Bundles the hardware model as plain arrays (host side, numpy)."""

    n_pes: int = N_PES
    n_clusters: int = N_CLUSTERS
    n_task_types: int = N_TASK_TYPES
    pe_cluster: np.ndarray = dataclasses.field(default_factory=lambda: PE_CLUSTER)
    cluster_pe_mask: np.ndarray = dataclasses.field(
        default_factory=lambda: CLUSTER_PE_MASK
    )
    exec_time: np.ndarray = dataclasses.field(default_factory=lambda: EXEC_TIME)
    cluster_power: np.ndarray = dataclasses.field(
        default_factory=lambda: CLUSTER_POWER
    )
    task_energy: np.ndarray = dataclasses.field(default_factory=lambda: TASK_ENERGY)
    lut_cluster: np.ndarray = dataclasses.field(default_factory=lambda: LUT_CLUSTER)
    us_per_kb: float = float(US_PER_KB)

    def exec_on_pe(self) -> np.ndarray:
        """[task_type, pe] execution-time table."""
        return self.exec_time[:, self.pe_cluster]


def validate_config(cfg: SoCConfig) -> SoCConfig:
    """Sanity-check a hardware model before it reaches the simulator
    (a malformed table there turns into NaN results, not errors)."""
    pe_cluster = np.asarray(cfg.pe_cluster)
    mask = np.asarray(cfg.cluster_pe_mask)
    exec_t = np.asarray(cfg.exec_time)
    power = np.asarray(cfg.cluster_power)
    energy = np.asarray(cfg.task_energy)
    lut = np.asarray(cfg.lut_cluster)
    if pe_cluster.shape != (cfg.n_pes,):
        raise ValueError(
            f"SoCConfig: pe_cluster shape {pe_cluster.shape} != ({cfg.n_pes},)")
    if ((pe_cluster < 0) | (pe_cluster >= cfg.n_clusters)).any():
        raise ValueError("SoCConfig: pe_cluster entries out of range")
    if mask.shape != (cfg.n_clusters, cfg.n_pes):
        raise ValueError(
            f"SoCConfig: cluster_pe_mask shape {mask.shape} != "
            f"({cfg.n_clusters}, {cfg.n_pes})")
    if not (mask.sum(axis=0) == 1).all():
        raise ValueError("SoCConfig: every PE must belong to exactly one "
                         "cluster in cluster_pe_mask")
    for name, table in (("exec_time", exec_t), ("task_energy", energy)):
        if table.shape != (cfg.n_task_types, cfg.n_clusters):
            raise ValueError(
                f"SoCConfig: {name} shape {table.shape} != "
                f"({cfg.n_task_types}, {cfg.n_clusters})")
        if np.isnan(table).any():
            raise ValueError(f"SoCConfig: {name} contains NaN")
        if (table[np.isfinite(table)] <= 0).any():
            raise ValueError(f"SoCConfig: {name} entries must be positive "
                             "(inf = cannot run)")
    if not np.isfinite(exec_t).any(axis=1).all():
        raise ValueError("SoCConfig: some task type cannot run anywhere")
    if power.shape != (cfg.n_clusters,) or (power <= 0).any() \
            or np.isnan(power).any():
        raise ValueError("SoCConfig: cluster_power must be positive, "
                         f"shape ({cfg.n_clusters},)")
    if lut.shape != (cfg.n_task_types,) \
            or ((lut < 0) | (lut >= cfg.n_clusters)).any():
        raise ValueError("SoCConfig: lut_cluster entries out of range")
    if not np.isfinite(exec_t[np.arange(cfg.n_task_types), lut]).all():
        raise ValueError("SoCConfig: lut_cluster points a task type at a "
                         "cluster that cannot run it")
    if not (np.isfinite(cfg.us_per_kb) and cfg.us_per_kb >= 0):
        raise ValueError("SoCConfig: us_per_kb must be finite and >= 0")
    return cfg


def default_soc() -> SoCConfig:
    return SoCConfig()


def big_cluster_pes() -> Tuple[int, int]:
    """(start, count) of the Arm big cluster PEs (used by the DAS feature)."""
    return int(CLUSTER_PE_START[BIG]), PES_PER_CLUSTER[BIG]
