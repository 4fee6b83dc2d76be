"""Phase-decomposed convolution apply: the fast path for periodic geometry.

For periodic geometry (phase.py), the interior resampling is exactly a
strided VALID cross-correlation: every (row-phase, column-phase) pair owns
one (fs, fs) coefficient block. The interior is an XLA shift-sum: unrolled
shifted strided slices times scalar weights, which XLA fuses into
elementwise code with no gathers. Past ``SHIFT_UNROLL_MAX`` taps a deep-tap
form (``_shift_sum_scan``) keeps the program small. Exception rows/columns
(float32 position drift) and border strips are patched with small targeted
computations.

Where the reference's SIMD gather loops (resize_plane_avx512.cpp et al.)
minimize per-pixel work via deduplicated table reads from L2, this form
reshapes the same deduplicated operator into dense strided multiply-adds
with no per-pixel table reads (SURVEY.md §7 "hard parts": gather
irregularity).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .apply_xla import (
    PARITY_PRECISION,
    DevicePlaneOperator,
    finalize,
    tap_sum,
    to_device,
    varying_zeros,
)
from .operator import PlaneOperator
from .phase import PhasePlan, build_conv_kernels, plan_phases

f32 = jnp.float32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["kernels", "dop", "exc_x", "exc_y"],
    meta_fields=["meta", "phase_offsets"],
)
@dataclass(frozen=True)
class ConvOperator:
    """Device-resident phase-conv operator (kernels + fixup metadata)."""

    kernels: jax.Array  # (py*px, 1, Kh, Kw) float32
    dop: DevicePlaneOperator
    exc_x: jax.Array  # (mx,) int32 exception columns (may be empty)
    exc_y: jax.Array  # (my,) int32 exception rows
    meta: tuple  # static geometry tuple — see build_conv_operator
    phase_offsets: tuple = ()  # static ((oy, ox), ...) per phase channel


def build_conv_operator(
    op: PlaneOperator, plan: PhasePlan | None = None
) -> ConvOperator | None:
    """Compile a PlaneOperator into its phase-conv form; None if aperiodic."""
    if plan is None:
        plan = plan_phases(op)
    if plan is None:
        return None
    K = build_conv_kernels(op, plan)
    Kh, Kw = K.shape[2], K.shape[3]
    meta = (
        plan.y.lo,
        plan.x.lo,
        plan.y.p,
        plan.x.p,
        plan.y.q,
        plan.x.q,
        plan.y.base,
        plan.x.base,
        plan.y.nblocks,
        plan.x.nblocks,
        Kh,
        Kw,
    )
    offs_y = plan.y.offsets
    offs_x = plan.x.offsets
    phase_offsets = tuple(
        (int(offs_y[ry]), int(offs_x[rx]))
        for ry in range(plan.y.p)
        for rx in range(plan.x.p)
    )
    return ConvOperator(
        kernels=jnp.asarray(K),
        dop=to_device(op),
        exc_x=jnp.asarray(plan.x.exceptions.astype(np.int32)),
        exc_y=jnp.asarray(plan.y.exceptions.astype(np.int32)),
        meta=meta,
        phase_offsets=phase_offsets,
    )


# ---------------------------------------------------------------------------
# Fixup computations (exceptions + strips): small targeted gathers.
#
# Per-pixel sums run in the golden's tap order (apply_xla.tap_sum); the one
# contraction left names PARITY_PRECISION (HIGHEST). On the GPU a float32
# dot_general left at DEFAULT precision may run on the tensor cores in TF32
# (10-bit mantissa), which breaks the 1-LSB / 2e-6 parity bounds against
# the host golden; HIGHEST keeps full float32 products.
# tests/test_precision.py lowers the parity-path jits and checks every
# dot_general for it.
# ---------------------------------------------------------------------------


def _cols_subset(dop: DevicePlaneOperator, src_f, sel) -> jax.Array:
    """Recompute a subset of destination columns (all rows): (dst_h, m)."""
    fs = dop.filter_size
    H, W = src_f.shape
    taps = jnp.arange(fs, dtype=jnp.int32)
    cols = jnp.clip(dop.start_x[sel][:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, cols]  # (H, m, fs)
    cxs = dop.cx_idx[sel]
    acc = jnp.zeros((dop.dst_height, sel.shape[0]), dtype=f32)
    for ly in range(fs):
        rows = jnp.clip(dop.start_y + ly, 0, H - 1)
        Prow = P[rows]  # (dst_h, m, fs)
        panex = dop.pair_blocks[:, cxs, ly, :]  # (n_uy, m, fs)
        Wrow = panex[dop.cy_idx]  # (dst_h, m, fs)
        acc = acc + jnp.einsum(
            "ymk,ymk->ym",
            Prow,
            Wrow,
            preferred_element_type=f32,
            precision=PARITY_PRECISION,
        )
    return acc


def _rows_subset(dop: DevicePlaneOperator, src_f, sel) -> jax.Array:
    """Recompute a subset of destination rows (all columns): (m, dst_w)."""
    fs = dop.filter_size
    H, W = src_f.shape
    m = sel.shape[0]
    taps = jnp.arange(fs, dtype=jnp.int32)
    rows_n = jnp.clip(dop.start_y[sel][:, None] + taps[None, :], 0, H - 1)
    S = src_f[rows_n.reshape(-1)]  # (m*fs, W)
    cols = jnp.clip(dop.start_x[:, None] + taps[None, :], 0, W - 1)
    P = S[:, cols].reshape(m, fs, dop.dst_width, fs)  # (m, k, w, l)
    pane_sel = dop.pair_blocks[dop.cy_idx[sel]]  # (m, n_ux, fs, fs)
    Wm = pane_sel[:, dop.cx_idx]  # (m, w, fs, fs)
    return tap_sum(jnp.moveaxis(P, 1, 0), Wm)


def _strip_values(dop: DevicePlaneOperator, src_f, s) -> jax.Array:
    """Per-pixel border strip apply: (ny, nx) via one im2col + einsum."""
    fs = dop.filter_size
    H, W = src_f.shape
    taps = jnp.arange(fs, dtype=jnp.int32)
    cols = jnp.clip(dop.start_x[s.x0 : s.x1][:, None] + taps[None, :], 0, W - 1)
    P = src_f[:, cols]  # (H, nx, fs)
    rows = jnp.clip(dop.start_y[s.y0 : s.y1][:, None] + taps[None, :], 0, H - 1)
    G = P[rows]  # (ny, k, nx, l)
    return tap_sum(jnp.moveaxis(G, 1, 0), s.blocks)


def apply_strips(dop: DevicePlaneOperator, src_f, canvas) -> jax.Array:
    for s in dop.strips:
        vals = _strip_values(dop, src_f, s)
        canvas = jax.lax.dynamic_update_slice(canvas, vals, (s.y0, s.x0))
    return canvas


# ---------------------------------------------------------------------------
# Full conv apply.
# ---------------------------------------------------------------------------


def _assemble(
    cop: ConvOperator, conv: jax.Array, src_f: jax.Array, strips_fn=None
) -> jax.Array:
    """Interleave the (py*px, nyb, nxb) phase planes into the canvas, then
    patch exception rows/columns and border strips over it."""
    dop = cop.dop
    (ylo, xlo, py, px, qy, qx, base_y, base_x, nyb, nxb, Kh, Kw) = cop.meta
    block = (
        conv.reshape(py, px, nyb, nxb)
        .transpose(2, 0, 3, 1)
        .reshape(py * nyb, px * nxb)
    )
    canvas = jnp.zeros((dop.dst_height, dop.dst_width), dtype=f32)
    canvas = jax.lax.dynamic_update_slice(canvas, block, (ylo, xlo))

    # Exception fixups (float32 drift deviations + partial trailing periods).
    if cop.exc_x.shape[0]:
        vals = _cols_subset(dop, src_f, cop.exc_x)
        canvas = canvas.at[:, cop.exc_x].set(vals)
    if cop.exc_y.shape[0]:
        vals = _rows_subset(dop, src_f, cop.exc_y)
        canvas = canvas.at[cop.exc_y, :].set(vals)

    # Border strips.
    if strips_fn is not None:
        canvas = strips_fn(dop, src_f, canvas)
    else:
        canvas = apply_strips(dop, src_f, canvas)
    return canvas


def _shift_sum_scan(lhs_g, Kg, qy, qx, nyb, nxb):
    """Scan-form shift-sum for large tap counts.

    The unrolled form emits Kh*Kw slice+FMA HLO ops — 4225 at tap16
    downscales (fs=65), which makes the program too large to compile in
    reasonable time and memory. A ``lax.scan`` over the tap rows with the
    tap columns unrolled in its body keeps the program at O(fb) ops, and
    keeps the golden's row-major tap order, so the float32 sums match the
    unrolled form's.

    ``lhs_g``: the offset-adjusted source window, at least
    ((nyb-1)*qy + fa, (nxb-1)*qx + fb); ``Kg``: (nphase, fa, fb) tap weights.
    """
    nph, fa, fb = Kg.shape
    band_h = (nyb - 1) * qy + 1

    def body(acc, xs):
        k_row, a = xs  # (nph, fb) weights of tap row a
        band = jax.lax.dynamic_slice_in_dim(lhs_g, a, band_h, axis=0)
        for b in range(fb):
            win = jax.lax.slice(
                band, (0, b), (band_h, b + (nxb - 1) * qx + 1), (qy, qx)
            )
            acc = acc + k_row[:, b][:, None, None] * win[None]
        return acc, None

    acc, _ = jax.lax.scan(
        body,
        varying_zeros((nph, nyb, nxb), lhs_g, Kg),
        (jnp.moveaxis(Kg, 1, 0), jnp.arange(fa, dtype=jnp.int32)),
    )
    return acc


# Past this many taps the unrolled shift-sum is replaced by the deep-tap
# form: an unrolled program of fs=41 (tap10 2x downscale, 1681 taps) already
# takes minutes to compile.
SHIFT_UNROLL_MAX = 1200


def phase_interior(lhs, K, offsets, qy, qx, nyb, nxb, fs) -> jax.Array:
    """Phase-decomposed strided correlation: (nphase, nyb, nxb).

    ``lhs`` is the source window whose (0, 0) is block 0's window start, at
    least ((nyb-1)*qy + Kh, (nxb-1)*qx + Kw); ``K`` (nphase, Kh, Kw) holds
    each phase's block at its static embedding ``offsets[p] = (oy, ox)``.

    An unrolled shift-sum rather than lax.conv: each tap (a, b) contributes
    K[:, a, b] times the same strided window slice to every phase channel,
    and the Kh*Kw slices + scalar-weight FMAs fuse into elementwise code
    with zero gathers. The taps accumulate in the golden's row-major order.
    """
    nphase, Kh, Kw = K.shape

    def window(a, b):
        return jax.lax.slice(
            lhs,
            (a, b),
            (a + (nyb - 1) * qy + 1, b + (nxb - 1) * qx + 1),
            (qy, qx),
        )

    if Kh * Kw <= 1.3 * fs * fs or len(set(offsets)) == 1:
        # Shared-slice shift-sum: every tap window feeds all phase channels.
        if Kh * Kw > SHIFT_UNROLL_MAX:
            return _shift_sum_scan(lhs, K, qy, qx, nyb, nxb)
        conv = jnp.zeros((nphase, nyb, nxb), dtype=f32)
        for a in range(Kh):
            for b in range(Kw):
                conv = conv + K[:, a, b][:, None, None] * window(a, b)[None]
        return conv
    # Offset-grouped: phases sharing an embedding offset share slices,
    # skipping the embedding-margin zeros (wide-offset plans).
    groups: dict[tuple[int, int], list[int]] = {}
    for p, off in enumerate(offsets):
        groups.setdefault(off, []).append(p)
    parts = [None] * nphase
    for (oy, ox), ps in groups.items():
        Kg = K[jnp.asarray(ps)][:, oy : oy + fs, ox : ox + fs]
        if fs * fs > SHIFT_UNROLL_MAX:
            acc_g = _shift_sum_scan(lhs[oy:, ox:], Kg, qy, qx, nyb, nxb)
        else:
            acc_g = jnp.zeros((len(ps), nyb, nxb), dtype=f32)
            for a in range(fs):
                for b in range(fs):
                    acc_g = acc_g + Kg[:, a, b][:, None, None] * window(
                        oy + a, ox + b
                    )[None]
        for i, p in enumerate(ps):
            parts[p] = acc_g[i]
    return jnp.stack(parts, axis=0)


def conv_window(cop: ConvOperator, src_f: jax.Array) -> jax.Array:
    """The interior's source window: (eh, ew) from (base_y, base_x), with
    zero padding past the plane's bottom/right edge."""
    (ylo, xlo, py, px, qy, qx, base_y, base_x, nyb, nxb, Kh, Kw) = cop.meta
    H, W = src_f.shape
    eh = (nyb - 1) * qy + Kh
    ew = (nxb - 1) * qx + Kw
    pad_h = max(0, base_y + eh - H)
    pad_w = max(0, base_x + ew - W)
    if pad_h or pad_w:
        src_f = jnp.pad(src_f, ((0, pad_h), (0, pad_w)))
    return jax.lax.dynamic_slice(src_f, (base_y, base_x), (eh, ew))


def apply_plane_conv(
    cop: ConvOperator,
    src: jax.Array,
    float_clamp_min: float | None = None,
    strips_fn=None,
) -> jax.Array:
    """Resample one plane via the phase conv + fixups: float32 accumulator."""
    (ylo, xlo, py, px, qy, qx, base_y, base_x, nyb, nxb, Kh, Kw) = cop.meta
    src_f = src.astype(f32)
    if float_clamp_min is not None:
        src_f = jnp.maximum(src_f, jnp.float32(float_clamp_min))
    conv = phase_interior(
        conv_window(cop, src_f),
        cop.kernels[:, 0],
        cop.phase_offsets,
        qy,
        qx,
        nyb,
        nxb,
        cop.dop.filter_size,
    )
    return _assemble(cop, conv, src_f, strips_fn=strips_fn)


@partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
def resize_plane_conv(
    cop: ConvOperator,
    src: jax.Array,
    out_dtype=jnp.float32,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> jax.Array:
    return finalize(apply_plane_conv(cop, src, float_clamp_min), out_dtype, peak)


class ConvApplier:
    """Phase-conv applier: shift-sum interior, gather-free strips where the
    strip plans allow, exception fixups. Holds its own jit caches.

    ``precision`` is validated for the API surface; every mode runs full
    float32 math, so ``effective_precision`` is always 'fp32'.
    """

    interior = "shift"
    effective_precision = "fp32"

    def __init__(self, op, plan=None, precision: str = "fp32"):
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"ConvApplier: unknown precision {precision!r}")
        self.precision = precision
        if plan is None:
            plan = plan_phases(op)
        if plan is None:
            raise ValueError("ConvApplier: geometry is aperiodic")
        self.cop = build_conv_operator(op, plan)
        from .apply_strips_fast import apply_strips_fast, plan_strips

        plans = plan_strips(op, plan)
        self._strips_fn = None
        if plans is not None:
            self._strips_fn = lambda dop, s, c: apply_strips_fast(dop, plans, s, c)
        # cop is a jit ARGUMENT (not a closure): closure capture would embed
        # the strip blocks as HLO constants — hundreds of MB at 8K.
        self._jit = jax.jit(
            self._apply, static_argnames=("out_dtype", "peak", "float_clamp_min")
        )
        self._jit_batch = jax.jit(
            self._apply_batch,
            static_argnames=("out_dtype", "peak", "float_clamp_min"),
        )

    def _apply(
        self, cop, src, out_dtype=jnp.float32, peak=None, float_clamp_min=None
    ):
        acc = apply_plane_conv(cop, src, float_clamp_min, strips_fn=self._strips_fn)
        return finalize(acc, out_dtype, peak)

    def _apply_batch(
        self, cop, src, out_dtype=jnp.float32, peak=None, float_clamp_min=None
    ):
        fn = lambda s: self._apply(cop, s, out_dtype, peak, float_clamp_min)
        return jax.vmap(fn)(src)

    def __call__(self, src, out_dtype=jnp.float32, peak=None, float_clamp_min=None):
        jit = self._jit_batch if src.ndim == 3 else self._jit
        return jit(
            self.cop,
            src,
            out_dtype=out_dtype,
            peak=peak,
            float_clamp_min=float_clamp_min,
        )


@partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
def resize_plane_conv_batch(
    cop: ConvOperator,
    src: jax.Array,  # (F, H, W)
    out_dtype=jnp.float32,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> jax.Array:
    fn = lambda s: finalize(apply_plane_conv(cop, s, float_clamp_min), out_dtype, peak)
    return jax.vmap(fn)(src)
