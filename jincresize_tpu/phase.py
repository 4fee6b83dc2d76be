"""Phase compiler: detect periodic structure of the resampling geometry.

The reference's quantized geometry is, for rational scale factors, periodic:
destination columns repeat their (quantization class, window-start advance)
pattern with period p while the source window advances by q — float32
position drift (the reference accumulates ``xpos += x_step`` in float32,
JincResize.cpp:524) breaks the pattern at a small set of *exception* columns.

This module detects, per axis, the smallest (p, q) pattern over the interior
coordinates and the exception set. A periodic axis pair turns the interior
apply into a phase-decomposed strided convolution (see apply_conv.py) with
zero gathers; exceptions and borders are patched separately. The reference
has no analog (its gather-MAC is insensitive to periodicity).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .operator import PlaneOperator


@dataclass(frozen=True)
class AxisPhasePlan:
    """Periodic structure of one destination axis over its interior range."""

    lo: int  # interior start (first non-border coordinate)
    hi: int  # end of the phase-covered range (lo + p * nblocks)
    p: int  # destination period
    q: int  # source window advance per period
    anchor_start: np.ndarray  # (p,) int: start[lo + r]
    anchor_cls: np.ndarray  # (p,) int32: dictionary index cx_idx[lo + r]
    exceptions: np.ndarray  # coordinates (absolute) deviating from the pattern
    nblocks: int  # number of full periods covered

    @property
    def offsets(self) -> np.ndarray:
        """Kernel embedding offsets per phase: start relative to the minimum."""
        return self.anchor_start - self.anchor_start.min()

    @property
    def base(self) -> int:
        """Source base coordinate of block 0 (minimum anchor start)."""
        return int(self.anchor_start.min())


def _plan_axis(
    cls_idx: np.ndarray,
    start: np.ndarray,
    lo: int,
    hi: int,
    max_period: int = 64,
    max_exception_frac: float = 0.25,
) -> AxisPhasePlan | None:
    """Find the smallest (p, q) pattern on [lo, hi); None if nothing usable."""
    n = hi - lo
    if n < 2:
        return None
    c = cls_idx[lo:hi]
    s = start[lo:hi]
    best = None
    # A usable period must actually repeat: p close to n makes every axis
    # trivially "periodic" (k//p == 0 almost everywhere) and explodes the
    # phase count — require at least 3 full repetitions.
    for p in range(1, min(max_period, n // 3) + 1):
        q = int(s[p] - s[0])
        if q < 0:
            continue
        k = np.arange(n)
        expected_s = s[k % p] + (k // p) * q
        dev = (c != c[k % p]) | (s != expected_s)
        n_exc = int(dev.sum())
        if n_exc == 0:
            best = (p, q, dev)
            break
        if n_exc <= n * max_exception_frac and (
            best is None or n_exc < int(best[2].sum())
        ):
            best = (p, q, dev)
    if best is None:
        return None
    p, q, dev = best
    nblocks = n // p
    # Trailing partial period: treat as exceptions.
    tail = np.zeros(n, dtype=bool)
    tail[nblocks * p :] = True
    dev = dev | tail
    exceptions = lo + np.flatnonzero(dev)
    if len(exceptions) > n * max_exception_frac:
        return None
    return AxisPhasePlan(
        lo=lo,
        hi=lo + nblocks * p,
        p=p,
        q=q,
        anchor_start=s[:p].astype(np.int64),
        anchor_cls=c[:p].astype(np.int32),
        exceptions=exceptions,
        nblocks=nblocks,
    )


@dataclass(frozen=True)
class PhasePlan:
    """Joint plan: both axes periodic => interior is a strided convolution."""

    x: AxisPhasePlan
    y: AxisPhasePlan


# Conv-path cost guard: the unrolled interior does py*px*fs^2 scalar-weight
# FMAs worth of HLO; past ~32k ops compile time dwarfs any conv win — the
# XLA gather path handles such geometries better. Shared by plan_phases and the
# geometry_is_periodic probe so the drift hint can never claim a conv path
# that planning would decline.
MAX_UNROLL_OPS = 32768


def _within_cost_guard(p_y: int, p_x: int, fs: int) -> bool:
    return p_y * p_x * fs * fs <= MAX_UNROLL_OPS


def plan_phases(op: PlaneOperator, max_period: int = 64) -> PhasePlan | None:
    """Build the phase plan for an operator; None if either axis is aperiodic."""
    if op.x_hi <= op.x_lo or op.y_hi <= op.y_lo:
        return None
    px = _plan_axis(op.cx_idx, op.start_x, op.x_lo, op.x_hi, max_period)
    if px is None:
        return None
    py = _plan_axis(op.cy_idx, op.start_y, op.y_lo, op.y_hi, max_period)
    if py is None:
        return None
    if px.nblocks < 1 or py.nblocks < 1:
        return None
    if not _within_cost_guard(py.p, px.p, op.filter_size):
        return None
    return PhasePlan(x=px, y=py)


def select_engine(op: PlaneOperator) -> tuple[str, PhasePlan | None]:
    """Execution engine for one plane geometry, decided by the geometry alone.

    ``('conv', plan)`` when both axes are periodic: the phase-decomposed
    shift-sum (apply_conv.ConvApplier on one device,
    sharding.make_sharded_apply_conv on a mesh). Otherwise ``('xla', None)``:
    the im2col gather-MAC (apply_xla) on one device, the uniform gather form
    on a mesh. api.py and sharding.py both route through this function.
    """
    plan = plan_phases(op)
    return ("conv", plan) if plan is not None else ("xla", None)


def geometry_is_periodic(g, max_period: int = 64) -> bool:
    """Cheap phase-plan probe on a PlaneGeometry (no coefficient build).

    Used for the drift hint (api.py): when the parity (f32-position) operator
    lands on the gather/XLA path, this checks whether the same request under
    ``pos_dtype='f64'`` would plan onto the conv path — classes and starts
    are all that planning needs, and a geometry build is milliseconds while
    an operator build is seconds. Uses the same _plan_axis detector and
    _within_cost_guard predicate as plan_phases, so the two cannot drift.
    """
    from .operator import _contiguous_border

    fs = g.filter_size
    plans = []
    for ax in (g.y, g.x):
        lo, hi = _contiguous_border(ax.border)
        p = _plan_axis(ax.qclass, ax.start, lo, hi, max_period)
        if p is None:
            return False
        plans.append(p)
    return _within_cost_guard(plans[0].p, plans[1].p, fs)


def build_conv_kernels(op: PlaneOperator, plan: PhasePlan) -> np.ndarray:
    """Embed per-phase-pair coefficient blocks into conv kernels.

    Returns (py*px, 1, Kh, Kw) float32 with each phase's (fs, fs) block placed
    at its source-offset within the enlarged shared window, so one VALID
    conv with strides (qy, qx) computes every phase as an output channel.
    """
    fs = op.filter_size
    offs_y = plan.y.offsets
    offs_x = plan.x.offsets
    Kh = fs + int(offs_y.max())
    Kw = fs + int(offs_x.max())
    py, px = plan.y.p, plan.x.p
    K = np.zeros((py * px, 1, Kh, Kw), dtype=np.float32)
    for ry in range(py):
        for rx in range(px):
            blk = op.pair_blocks[plan.y.anchor_cls[ry], plan.x.anchor_cls[rx]]
            oy, ox = int(offs_y[ry]), int(offs_x[rx])
            K[ry * px + rx, 0, oy : oy + fs, ox : ox + fs] = blk
    return K
