"""Frame-level rate control — JVT-G012 quadratic model (JM `ratectl.c` /
`rc_quadratic.c` capability — SURVEY.md §2a #17).

The port's own copy of `tpu264.runtime.ratectl`, with the same operations
in the same order, so that it chooses the same QPs (host float math;
`tests/test_torch_ratectl.py` holds the two to each other).

Host-side per SURVEY's design (tiny sequential math).  Per frame:
  1. target bits  T = remaining-budget share + buffer feedback
  2. MAD prediction: linear model  MAD_pred = a1 * MAD_prev + a2
  3. quadratic R-Q: T = c1 * MAD/Qstep + c2 * MAD/Qstep^2  -> solve Qstep
  4. QP from Qstep (QP = 4 + 6*log2(Qstep)), clamped to +-2 vs previous
     frame and [qp_min, qp_max]
  5. after encoding: update model parameters with (actual bits, MAD) by
     windowed least squares (JM's sliding-window regression).
"""

from __future__ import annotations

import math


def qp_to_qstep(qp: float) -> float:
    return 2.0 ** ((qp - 4) / 6.0)


def qstep_to_qp(qs: float) -> float:
    return 4 + 6 * math.log2(max(qs, 1e-6))


class RateController:
    def __init__(self, bitrate: float, frame_rate: float, n_mbs: int,
                 init_qp: int = 28, qp_min: int = 1, qp_max: int = 51,
                 window: int = 20):
        self.bpf = bitrate / frame_rate          # bits per frame budget
        self.n_mbs = n_mbs
        self.qp_min, self.qp_max = qp_min, qp_max
        self.window = window
        self.prev_qp = init_qp
        self.curr_qp = init_qp
        # quadratic model coefficients (JM initial values)
        self.c1 = self.bpf / 2.0
        self.c2 = 0.0
        # MAD linear prediction model
        self.a1, self.a2 = 1.0, 0.0
        self.mad_prev = None
        self.buffer = 0.0                        # virtual buffer fullness
        self.history: list[tuple[float, float, float]] = []  # (bits,mad,qstep)
        self.i_ratio = 3.0                       # I frames cost ~3x a P
        self.avg_b = None                        # EMA of B-frame bits
        self._pending_qstep = None

    # ------------------------------------------------------------ per frame
    def frame_qp(self, frame_type: str, num_b: int = 0) -> int:
        """QP for the next I/P frame.  `num_b`: B frames riding on this
        anchor (hierarchical GOPs) — the anchor absorbs the whole
        sub-GOP budget minus the expected B cost."""
        if self.mad_prev is None or frame_type == "I":
            # first frame / IDR: QP from bits-per-pixel heuristic (JM
            # InitialQP table spirit) anchored at the running average QP
            qp = self.curr_qp
            self.prev_qp = qp
            return qp
        # 1. target bits with buffer feedback: drain the accumulated
        # error over ~2 frames (stronger than G012's slow gamma so the
        # integer-QP quantization dithers between adjacent QPs and the
        # long-run average tracks the target within a few percent)
        gross = self.bpf * (1 + num_b)
        exp_b = (num_b * self.avg_b) if (num_b and self.avg_b) else 0.0
        target = gross - exp_b - self.buffer / 2.0
        target = min(max(target, self.bpf * 0.1), gross * 4.0)
        # 2. MAD prediction
        mad = max(self.a1 * self.mad_prev + self.a2, 1e-3)
        # 3. solve c2/Q^2 + c1/Q - T/MAD = 0 for Qstep
        t = target / (mad * self.n_mbs * 256.0)
        c1, c2 = self.c1 / (self.n_mbs * 256.0), self.c2 / (self.n_mbs * 256.0)
        if abs(c2) < 1e-9:
            qs = c1 / max(t, 1e-9)
        else:
            disc = c1 * c1 + 4 * c2 * t
            qs = (2 * c2) / max(-c1 + math.sqrt(max(disc, 0.0)), 1e-9)
            if qs <= 0:
                qs = c1 / max(t, 1e-9)
        qp = int(round(qstep_to_qp(qs)))
        # JM clamps +-2 per coded frame; an anchor stands in for its
        # whole 1 + num_b sub-GOP, so its step budget scales with it
        step = 2 + num_b
        qp = max(self.prev_qp - step, min(self.prev_qp + step, qp))
        qp = max(self.qp_min, min(self.qp_max, qp))
        self.prev_qp = qp
        self._pending_qstep = qp_to_qstep(qp)
        return qp

    def update(self, frame_type: str, bits: int, mad: float) -> None:
        # every frame is charged exactly its bpf share: IDR overshoot
        # lands in the buffer and is drained by the following frames, so
        # the TOTAL budget stays n_frames * bpf (<=5% tracking)
        self.buffer += bits - self.bpf
        if frame_type == "B":
            # B frames ride the buffer only: their R-Q behavior (higher
            # QP, direct/skip-heavy) would pollute the P quadratic model
            self.avg_b = (float(bits) if self.avg_b is None
                          else 0.75 * self.avg_b + 0.25 * bits)
            return
        mad = max(mad, 1e-3)
        qs = (self._pending_qstep if self._pending_qstep is not None
              else qp_to_qstep(self.prev_qp))
        self._pending_qstep = None
        if frame_type != "I":
            self.history.append((float(bits), mad, qs))
            if len(self.history) > self.window:
                self.history.pop(0)
            self._fit_quadratic()
            if self.mad_prev is not None:
                self._fit_mad(mad)
        self.mad_prev = mad
        self.curr_qp = self.prev_qp

    # ----------------------------------------------------- checkpoint state
    _STATE_KEYS = ("bpf", "prev_qp", "curr_qp", "c1", "c2", "a1", "a2",
                   "mad_prev", "buffer", "i_ratio", "avg_b")

    def get_state(self) -> dict:
        """JSON-serializable snapshot (checkpoint/resume — SURVEY.md §5)."""
        st = {k: getattr(self, k) for k in self._STATE_KEYS}
        st["history"] = [list(h) for h in self.history]
        return st

    def set_state(self, st: dict) -> None:
        for k in self._STATE_KEYS:
            setattr(self, k, st.get(k, getattr(self, k)))
        self.history = [tuple(h) for h in st["history"]]
        self._pending_qstep = None

    # ------------------------------------------------------------- fitting
    def _avg_weight(self) -> float:
        return 1.0   # flat allocation: I overshoot is absorbed by `buffer`

    def _fit_quadratic(self) -> None:
        """Windowed least squares of bits/MAD = c1/Q + c2/Q^2."""
        n = len(self.history)
        if n == 0:
            return
        if n == 1:
            b, m, q = self.history[0]
            self.c1 = b * q / m
            self.c2 = 0.0
            return
        s11 = s12 = s22 = r1 = r2 = 0.0
        for b, m, q in self.history:
            x1, x2 = 1.0 / q, 1.0 / (q * q)
            yv = b / m
            s11 += x1 * x1
            s12 += x1 * x2
            s22 += x2 * x2
            r1 += x1 * yv
            r2 += x2 * yv
        det = s11 * s22 - s12 * s12
        if abs(det) < 1e-12:
            b, m, q = self.history[-1]
            self.c1 = b * q / m
            self.c2 = 0.0
            return
        self.c1 = (r1 * s22 - r2 * s12) / det
        self.c2 = (r2 * s11 - r1 * s12) / det
        if self.c1 < 0:                      # keep the model sane (JM guard)
            b, m, q = self.history[-1]
            self.c1 = b * q / m
            self.c2 = 0.0

    def _fit_mad(self, mad_actual: float) -> None:
        """One-step update of the linear MAD predictor (JM style)."""
        if self.mad_prev is None or self.mad_prev < 1e-6:
            return
        # exponential blend toward the observed ratio
        ratio = mad_actual / self.mad_prev
        self.a1 = 0.9 * self.a1 + 0.1 * ratio
        self.a2 = 0.9 * self.a2
