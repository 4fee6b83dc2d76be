"""Gather-free border-strip apply for periodic geometries.

Structural facts (from the reference's window clamping,
JincResize.cpp:395-418, reproduced by the builder):

  * every pixel of the top strip has window start_y == 0 (its unclamped begin
    was negative); bottom-strip rows share start_y == src_h - fs; left/right
    strip columns share start_x == 0 / src_w - fs;
  * the *other* axis of each strip follows the same periodic
    pattern-with-exceptions the phase compiler already extracted for the
    interior.

Implementation note: a strip touches only an (fs x W) source band. All
fs x fs tap windows of that band are materialized at once as a sliding-window
tensor (fs static slices), the per-destination window rows are assembled with
per-phase strided slices plus one small exception gather, and one tap sum
(apply_xla.tap_sum) against the per-pixel strip weights produces the strip.
Total ~30 XLA ops per strip, where the per-(ly,lx) formulation costs fs^2 tiny kernels whose
launch overhead alone can exceed the interior's time.

Falls back to the per-pixel strip path (apply_conv._strip_values) for degenerate
geometries (src smaller than the filter, aperiodic axes).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .apply_xla import tap_sum


@dataclass(frozen=True)
class StripPlan:
    """Static recipe for one strip's gather-free apply."""

    kind: str  # 'top' | 'bottom' | 'left' | 'right'
    const_start: int  # shared window start on the clamped axis
    # Free-axis periodic pattern (from the interior phase plan):
    lo: int  # first pattern-covered coordinate (absolute)
    p: int
    q: int
    anchor_start: tuple  # (p,) window starts of the anchor period
    nblocks: int
    exc: np.ndarray  # absolute free-axis coords needing the gather path
    rect: tuple  # (y0, y1, x0, x1)


def plan_strips(op, phase_plan) -> list[StripPlan] | None:
    """Build strip plans; None if preconditions fail (use the per-pixel fallback)."""
    fs = op.filter_size
    if op.src_width < fs or op.src_height < fs:
        return None
    plans = []
    px_plan, py_plan = phase_plan.x, phase_plan.y
    for s in op.strips:
        full_width = s.x0 == 0 and s.x1 == op.dst_width
        if full_width and s.y1 <= op.y_lo:
            kind, const, ax = "top", 0, px_plan
        elif full_width and s.y0 >= op.y_hi:
            kind, const, ax = "bottom", op.src_height - fs, px_plan
        elif s.x1 <= op.x_lo:
            kind, const, ax = "left", 0, py_plan
        elif s.x0 >= op.x_hi:
            kind, const, ax = "right", op.src_width - fs, py_plan
        else:
            return None
        if kind in ("top", "bottom"):
            starts = op.start_y[s.y0 : s.y1]
            f0, f1 = s.x0, s.x1
        else:
            starts = op.start_x[s.x0 : s.x1]
            f0, f1 = s.y0, s.y1
        if not (starts == const).all():
            return None
        rng = np.arange(f0, f1)
        exc_set = set(int(e) for e in ax.exceptions)
        exc = np.array(
            sorted(
                int(c)
                for c in rng
                if (c < ax.lo or c >= ax.lo + ax.p * ax.nblocks or c in exc_set)
            ),
            dtype=np.int32,
        )
        plans.append(
            StripPlan(
                kind=kind,
                const_start=const,
                lo=ax.lo,
                p=ax.p,
                q=ax.q,
                anchor_start=tuple(int(v) for v in ax.anchor_start),
                nblocks=ax.nblocks,
                exc=exc,
                rect=(s.y0, s.y1, s.x0, s.x1),
            )
        )
    return plans


def _sliding(band: jax.Array, fs: int, axis: int) -> jax.Array:
    """All length-fs windows along `axis` of a band, stacked on a new last axis.

    band (A, B) -> (A, B-fs+1, fs) for axis=1, or (A-fs+1, B, fs) for axis=0.
    """
    n = band.shape[axis] - fs + 1
    if axis == 1:
        parts = [jax.lax.slice(band, (0, t), (band.shape[0], t + n)) for t in range(fs)]
    else:
        parts = [jax.lax.slice(band, (t, 0), (t + n, band.shape[1])) for t in range(fs)]
    return jnp.stack(parts, axis=-1)


def _assemble_windows(
    S: jax.Array,  # (fs_c, U, fs_f): windows indexed by free-axis start
    sp: StripPlan,
    free_len: int,
    free0: int,
    starts_dev: jax.Array,  # device per-coordinate starts on the free axis
    exc_dev: jax.Array,
) -> jax.Array:
    """Per-destination-coordinate windows (fs_c, free_len, fs_f)."""
    n = sp.nblocks
    parts = [
        jax.lax.slice(
            S,
            (0, sp.anchor_start[r], 0),
            (S.shape[0], sp.anchor_start[r] + sp.q * (n - 1) + 1, S.shape[2]),
            (1, sp.q, 1),
        )
        for r in range(sp.p)
    ]
    mid = jnp.stack(parts, axis=2).reshape(S.shape[0], sp.p * n, S.shape[2])
    vec = jnp.zeros((S.shape[0], free_len, S.shape[2]), dtype=S.dtype)
    vec = jax.lax.dynamic_update_slice(vec, mid, (0, sp.lo - free0, 0))
    if exc_dev.shape[0]:
        ev = S[:, starts_dev[exc_dev], :]
        vec = vec.at[:, exc_dev - free0, :].set(ev)
    return vec


def apply_strips_fast(dop, strip_plans, src_f, canvas):
    """Write every strip into the canvas, with static slicing only."""
    fs = dop.filter_size
    for s, sp in zip(dop.strips, strip_plans):
        y0, y1, x0, x1 = sp.rect
        ny, nx = y1 - y0, x1 - x0
        c = sp.const_start
        if sp.kind in ("top", "bottom"):
            band = jax.lax.slice(src_f, (c, 0), (c + fs, src_f.shape[1]))
            S = _sliding(band, fs, axis=1)  # (fs_ly, U, fs_lx)
            vec = _assemble_windows(
                S, sp, nx, x0, dop.start_x, jnp.asarray(sp.exc)
            )  # (fs_ly, nx, fs_lx)
            acc = tap_sum(vec[:, None], s.blocks)
        else:
            band = jax.lax.slice(src_f, (0, c), (src_f.shape[0], c + fs))
            S0 = _sliding(band, fs, axis=0)  # (U, fs_lx, fs_ly)
            S = jnp.transpose(S0, (1, 0, 2))  # (fs_lx, U, fs_ly)
            vec = _assemble_windows(
                S, sp, ny, y0, dop.start_y, jnp.asarray(sp.exc)
            )  # (fs_lx, ny, fs_ly)
            acc = tap_sum(jnp.transpose(vec, (2, 1, 0))[:, :, None], s.blocks)
        canvas = jax.lax.dynamic_update_slice(canvas, acc, (y0, x0))
    return canvas
