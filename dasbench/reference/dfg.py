"""Data-flow-graph models of the five streaming applications.

A frozen copy of the port's `core/dfg.py` with its own task-type
vocabulary, so the benchmark's inputs do not come from the program.

The paper evaluates range detection, temporal mitigation, WiFi-TX, WiFi-RX and
a proprietary industrial application (App-1). The public DS3 release models
these as small DAGs (5-35 tasks) of domain kernels. We reconstruct
representative graphs from the application structure described in the paper
and the DS3 publication; see DESIGN.md section 8 for the assumptions.

Each application is a list of (task_type, preds, out_kb) tuples; preds are
indices into the same list. Graphs are DAGs with a single sink is NOT required
(instance latency = max finish over its tasks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the task-type vocabulary, in the order of the SoC tables' rows (each
# configuration file lists it under `soc.task_types`)
TASK_TYPE_NAMES = (
    "scrambler", "interleaver", "qpsk_mod", "pilot_insert", "fft", "ifft",
    "fir", "fec_enc", "fec_dec", "matmul", "demod", "sync",
)
T = {name: i for i, name in enumerate(TASK_TYPE_NAMES)}

# (task_type_name, predecessor indices, output kilobytes)
_Spec = Tuple[str, Tuple[int, ...], float]


def _app(spec: Sequence[_Spec]) -> "AppGraph":
    types = np.array([T[s[0]] for s in spec], dtype=np.int32)
    n = len(spec)
    preds: List[Tuple[int, ...]] = [tuple(s[1]) for s in spec]
    out_kb = np.array([s[2] for s in spec], dtype=np.float32)
    for i, p in enumerate(preds):
        assert all(q < i for q in p), f"task {i}: preds must precede"
    return AppGraph(types, preds, out_kb)


@dataclasses.dataclass(frozen=True)
class AppGraph:
    task_types: np.ndarray          # [n] int32
    preds: List[Tuple[int, ...]]    # per-task predecessor indices
    out_kb: np.ndarray              # [n] float32, output payload per task

    @property
    def n_tasks(self) -> int:
        return int(self.task_types.shape[0])

    def depths(self) -> np.ndarray:
        d = np.zeros(self.n_tasks, dtype=np.int32)
        for i, p in enumerate(self.preds):
            d[i] = 0 if not p else 1 + max(d[q] for q in p)
        return d

    def succs(self) -> List[List[int]]:
        s: List[List[int]] = [[] for _ in range(self.n_tasks)]
        for i, p in enumerate(self.preds):
            for q in p:
                s[q].append(i)
        return s


# ---------------------------------------------------------------------------
# WiFi transmitter: scramble -> FEC encode -> interleave -> {QPSK -> pilot
# insertion -> IFFT} over four parallel OFDM symbol lanes -> frame assembly.
# ---------------------------------------------------------------------------
_witx: List[_Spec] = [
    ("scrambler",   (),    4.0),   # 0
    ("fec_enc",     (0,),  8.0),   # 1
    ("interleaver", (1,),  8.0),   # 2
]
for _lane in range(4):
    b = len(_witx)
    _witx.append(("qpsk_mod",     (2,),     4.0))
    _witx.append(("pilot_insert", (b,),     4.0))
    _witx.append(("ifft",         (b + 1,), 8.0))
_witx.append(("sync", tuple(5 + 3 * k for k in range(4)), 2.0))  # assembly
WIFI_TX = _app(_witx)

# ---------------------------------------------------------------------------
# WiFi receiver: sync -> {FFT -> demod} over four symbol lanes ->
# deinterleave -> FEC decode (viterbi) -> descramble.
# ---------------------------------------------------------------------------
_wirx: List[_Spec] = [("sync", (), 8.0)]  # 0 payload detect / CFO
for _lane in range(4):
    b = len(_wirx)
    _wirx.append(("fft",   (0,),  8.0))
    _wirx.append(("demod", (b,),  4.0))
_wirx.append(("interleaver", tuple(2 + 2 * k for k in range(4)), 8.0))
_wirx.append(("fec_dec", (len(_wirx) - 1,), 8.0))
_wirx.append(("scrambler", (len(_wirx) - 1,), 4.0))
WIFI_RX = _app(_wirx)

# ---------------------------------------------------------------------------
# Range detection (pulse-doppler radar): reference + received FFT, conjugate
# multiply (on SAP), IFFT, magnitude + detection on CPU.
# ---------------------------------------------------------------------------
RANGE_DETECTION = _app([
    ("sync",    (),      8.0),   # 0  waveform gen / capture
    ("fft",     (0,),    8.0),   # 1  received
    ("fft",     (0,),    8.0),   # 2  reference
    ("matmul",  (1, 2),  8.0),   # 3  conj multiply
    ("ifft",    (3,),    8.0),   # 4
    ("demod",   (4,),    2.0),   # 5  magnitude + peak detect
])

# ---------------------------------------------------------------------------
# Temporal mitigation (interference cancellation): FIR filter banks feeding a
# systolic projection, second FIR pass, decision.
# ---------------------------------------------------------------------------
TEMPORAL_MITIGATION = _app([
    ("sync",    (),      8.0),   # 0
    ("fir",     (0,),    8.0),   # 1
    ("fir",     (0,),    8.0),   # 2
    ("matmul",  (1, 2),  8.0),   # 3  correlation
    ("matmul",  (3,),    8.0),   # 4  projection
    ("fir",     (4,),    8.0),   # 5
    ("fir",     (4,),    8.0),   # 6
    ("demod",   (5, 6),  2.0),   # 7
])

# ---------------------------------------------------------------------------
# App-1: proprietary industrial app; per the paper it is the largest,
# FFT/FIR-heavy radar-like pipeline. Modeled as a 4-channel pipeline with a
# matmul fusion stage, 21 tasks.
# ---------------------------------------------------------------------------
_app1_spec: List[_Spec] = [("sync", (), 16.0)]  # 0
for ch in range(4):                              # 4 channels x (fir->fft->fir)
    b = len(_app1_spec)
    _app1_spec.append(("fir", (0,), 8.0))        # b
    _app1_spec.append(("fft", (b,), 8.0))        # b+1
    _app1_spec.append(("fir", (b + 1,), 8.0))    # b+2
_fuse_preds = tuple(3 + 3 * ch for ch in range(4))  # last fir of each channel
_app1_spec.append(("matmul", _fuse_preds, 16.0))     # 13 fusion
_f = len(_app1_spec) - 1
_app1_spec.append(("matmul", (_f,), 16.0))           # 14 beamform
_app1_spec.append(("ifft", (_f + 1,), 8.0))          # 15
_app1_spec.append(("fec_enc", (_f + 2,), 8.0))       # 16 telemetry encode
_app1_spec.append(("qpsk_mod", (_f + 3,), 4.0))      # 17
_app1_spec.append(("ifft", (_f + 4,), 8.0))          # 18
_app1_spec.append(("sync", (_f + 5,), 2.0))          # 19
APP_1 = _app(_app1_spec)

APPS: Dict[str, AppGraph] = {
    "wifi_tx": WIFI_TX,
    "wifi_rx": WIFI_RX,
    "range_detection": RANGE_DETECTION,
    "temporal_mitigation": TEMPORAL_MITIGATION,
    "app_1": APP_1,
}
APP_NAMES: Tuple[str, ...] = tuple(APPS.keys())
N_APPS = len(APP_NAMES)
MAX_APP_TASKS = max(a.n_tasks for a in APPS.values())
MAX_PREDS = max(max((len(p) for p in a.preds), default=0) for a in APPS.values())
MAX_SUCCS = max(
    max((len(s) for s in a.succs()), default=0) for a in APPS.values()
)
MAX_ROOTS = max(
    sum(1 for p in a.preds if not p) for a in APPS.values()
)
