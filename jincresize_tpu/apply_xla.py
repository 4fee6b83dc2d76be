"""XLA general apply path: jitted gather-MAC over the device-resident operator.

Replacement for the reference's per-pixel SIMD gather loops
(``resize_plane_{c,sse41,avx2,avx512}`` — /root/reference/src/JincResize.cpp:536-601
and the resize_plane_*.cpp kernels): instead of a 48-way ISA dispatch, one
jitted program per plane geometry. XLA owns codegen; an ``impl`` switch at the
API level selects between this general path and the phase-conv path
(apply_conv.py) for periodic geometry.

Structure: the per-pixel weight for tap (ly, lx) is assembled as a
(dst_h, dst_w) map — interior via two *separable* gathers from the class-pair
dictionary, border strips via static dynamic-update-slices — then multiplied
with the separably-gathered source tap plane and accumulated in float32 in
the reference's ly-major/lx-minor order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .operator import PlaneOperator

# Precision of every contraction on the parity path (this module,
# apply_conv, apply_strips_fast, sharding). On the GPU a float32 dot_general
# at DEFAULT precision may run in TF32, which breaks parity with the host
# golden; HIGHEST keeps full float32 products.
PARITY_PRECISION = jax.lax.Precision.HIGHEST


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks"],
    meta_fields=["y0", "y1", "x0", "x1"],
)
@dataclass(frozen=True)
class DeviceStrip:
    """Device-resident border strip (static rectangle, per-pixel blocks)."""

    blocks: jax.Array  # (ny, nx, fs, fs) float32
    y0: int = 0
    y1: int = 0
    x0: int = 0
    x1: int = 0


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "start_x",
        "start_y",
        "cx_idx",
        "cy_idx",
        "pair_blocks",
        "strips",
    ],
    meta_fields=[
        "src_width",
        "src_height",
        "dst_width",
        "dst_height",
        "filter_size",
    ],
)
@dataclass(frozen=True)
class DevicePlaneOperator:
    """Frozen device pytree mirroring PlaneOperator (SURVEY.md §5: the operator
    is immutable by construction — written once at build, read-only per frame)."""

    start_x: jax.Array  # (dst_w,) int32
    start_y: jax.Array  # (dst_h,) int32
    cx_idx: jax.Array  # (dst_w,) int32
    cy_idx: jax.Array  # (dst_h,) int32
    pair_blocks: jax.Array  # (n_uy, n_ux, fs, fs) float32
    strips: tuple[DeviceStrip, ...]
    src_width: int = 0
    src_height: int = 0
    dst_width: int = 0
    dst_height: int = 0
    filter_size: int = 0


def to_device(op: PlaneOperator) -> DevicePlaneOperator:
    """Ship a host-built PlaneOperator to HBM as a frozen pytree."""
    strips = tuple(
        DeviceStrip(
            blocks=jnp.asarray(s.blocks), y0=s.y0, y1=s.y1, x0=s.x0, x1=s.x1
        )
        for s in op.strips
    )
    pair = op.pair_blocks
    if pair.size == 0:
        # Degenerate fully-border geometry: keep a 1x1 zero dictionary so the
        # gather path stays shape-valid; strips overwrite every pixel.
        fs = op.filter_size
        pair = np.zeros((1, 1, fs, fs), dtype=np.float32)
    return DevicePlaneOperator(
        start_x=jnp.asarray(op.start_x),
        start_y=jnp.asarray(op.start_y),
        cx_idx=jnp.asarray(op.cx_idx),
        cy_idx=jnp.asarray(op.cy_idx),
        pair_blocks=jnp.asarray(pair),
        strips=strips,
        src_width=op.src_width,
        src_height=op.src_height,
        dst_width=op.dst_width,
        dst_height=op.dst_height,
        filter_size=op.filter_size,
    )


def apply_plane(
    dop: DevicePlaneOperator,
    src: jax.Array,
    float_clamp_min: float | None = None,
) -> jax.Array:
    """Resample one plane: (src_h, src_w) -> (dst_h, dst_w) float32 accumulator.

    Structure: per-element 2-D gathers are index-bound, so the horizontal
    tap window is materialized ONCE as an im2col column gather
    ``P[src_row, x, lx]``; the per-tap-row work is then (a) a contiguous
    row gather of P (whole 522KB rows, near-memcpy), (b) a small column
    gather of the class dictionary, and (c) a fused multiply + lx-reduction.
    The lx reduction order may differ from the reference's serial loop — the
    reference's own SIMD paths reduce in yet another order (hsum trees,
    resize_plane_avx2.cpp:60-61), and parity tolerances account for this.

    Output conversion (rounding/clamping) is left to the caller so batching
    and sharding wrappers can fuse it. Gather indices are clipped to the plane
    for degenerate tiny sources (the reference over-reads its padded frames).
    """
    fs = dop.filter_size
    H, W = src.shape
    src_f = src.astype(jnp.float32)
    if float_clamp_min is not None:
        src_f = jnp.maximum(src_f, jnp.float32(float_clamp_min))

    n_uy, n_ux = dop.pair_blocks.shape[:2]
    # Horizontal im2col: (H, dst_w, fs). cols[x, lx] = clip(start_x + lx).
    cols = jnp.clip(
        dop.start_x[:, None] + jnp.arange(fs, dtype=jnp.int32)[None, :], 0, W - 1
    )
    P = src_f[:, cols]  # one 2-D gather along columns, reused for every ly

    if n_uy * H <= 2 * dop.dst_height:
        # Class-contraction variant: contract the horizontal taps once per
        # ROW CLASS over SOURCE rows (n_uy * H * dst_w values), then gather
        # each destination row's (class, src row) pair. Avoids materializing
        # the (dst_h, dst_w, fs) patch and weight tensors per tap row —
        # ~3x less HBM traffic whenever the row dictionary is small
        # (semi-periodic geometries, quant_y=1, modest upscales).
        acc = jnp.zeros((dop.dst_height, dop.dst_width), dtype=jnp.float32)
        for ly in range(fs):
            panex = dop.pair_blocks[:, dop.cx_idx, ly, :]  # (n_uy, dst_w, fs)
            T = jnp.einsum(
                "hwk,cwk->chw",
                P,
                panex,
                preferred_element_type=jnp.float32,
                precision=PARITY_PRECISION,
            )
            rows = jnp.clip(dop.start_y + ly, 0, H - 1)
            flat = dop.cy_idx.astype(jnp.int32) * H + rows
            acc = acc + T.reshape(n_uy * H, dop.dst_width)[flat]
        # Border pixels got interior-pattern weights above; overwrite with
        # their true per-pixel strip values (same final precedence as the
        # Wrow-update order of the general branch).
        for s in dop.strips:
            cols_s = jnp.clip(
                dop.start_x[s.x0 : s.x1, None]
                + jnp.arange(fs, dtype=jnp.int32)[None, :],
                0,
                W - 1,
            )
            Ps = src_f[:, cols_s]  # (H, nx, fs)
            rows_s = jnp.clip(
                dop.start_y[s.y0 : s.y1, None]
                + jnp.arange(fs, dtype=jnp.int32)[None, :],
                0,
                H - 1,
            )
            G = Ps[rows_s]  # (ny, k, nx, l)
            vals = tap_sum(jnp.moveaxis(G, 1, 0), s.blocks)
            acc = jax.lax.dynamic_update_slice(acc, vals, (s.y0, s.x0))
        return acc

    acc = jnp.zeros((dop.dst_height, dop.dst_width), dtype=jnp.float32)
    for ly in range(fs):
        rows = jnp.clip(dop.start_y + ly, 0, H - 1)
        Prow = P[rows]  # (dst_h, dst_w, fs) contiguous row gather
        # Per-row-class weight rows, expanded along x by class: small gather.
        panex = dop.pair_blocks[:, dop.cx_idx, ly, :]  # (n_uy, dst_w, fs)
        Wrow = panex[dop.cy_idx]  # (dst_h, dst_w, fs) row gather
        for s in dop.strips:
            ny, nx = s.blocks.shape[:2]
            sb = s.blocks[:, :, ly, :]  # (ny, nx, fs)
            Wrow = jax.lax.dynamic_update_slice(Wrow, sb, (s.y0, s.x0, 0))
        acc = acc + jnp.einsum(
            "ywk,ywk->yw",
            Prow,
            Wrow,
            preferred_element_type=jnp.float32,
            precision=PARITY_PRECISION,
        )
    return acc


def varying_zeros(shape, *like: jax.Array) -> jax.Array:
    """float32 zeros, as device-varying inside shard_map as ``like``: a
    scan's carry must have the type of the values it accumulates."""
    zeros = jnp.zeros(shape, jnp.float32)
    vma = tuple(sorted(set().union(*(jax.typeof(x).vma for x in like))))
    return jax.lax.pcast(zeros, vma, to="varying") if vma else zeros


def tap_sum(P: jax.Array, W: jax.Array) -> jax.Array:
    """``sum_{a,l} P[a, ..., l] * W[..., a, l]``, accumulated one tap at a
    time in row-major (a, l) order from zero — the golden's order
    (golden.apply_plane_numpy). A contraction would sum the fs^2 terms in
    its own order, whose float32 rounding differs from the golden's by
    more than 2e-6 at fs=65; in the golden's order only the rounding of
    each multiply-add can differ.

    ``P``: (fa, *batch, fl) windows, broadcastable against ``W``:
    (*batch, fa, fl) per-pixel blocks. A ``lax.scan`` over a with l unrolled
    keeps the program at O(fl) ops.
    """
    Wt = jnp.moveaxis(W, -2, 0)  # (fa, *batch, fl)

    def body(acc, xs):
        p, w = xs
        for l in range(p.shape[-1]):
            acc = acc + p[..., l] * w[..., l]
        return acc, None

    shape = jnp.broadcast_shapes(P.shape[1:-1], Wt.shape[1:-1])
    acc, _ = jax.lax.scan(body, varying_zeros(shape, P, Wt), (P, Wt))
    return acc


def finalize(acc: jax.Array, out_dtype, peak: float | None) -> jax.Array:
    """Reference output conversion: lrintf(clamp(r, 0, peak)) for integers
    (round half to even), raw float32 passthrough otherwise
    (JincResize.cpp:581-584)."""
    if np.issubdtype(np.dtype(out_dtype), np.integer):
        acc = jnp.clip(acc, 0.0, jnp.float32(peak))
        return jnp.rint(acc).astype(out_dtype)
    return acc.astype(out_dtype)


@partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
def resize_plane(
    dop: DevicePlaneOperator,
    src: jax.Array,
    out_dtype=jnp.float32,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> jax.Array:
    """Jitted single-plane resize with output conversion."""
    return finalize(apply_plane(dop, src, float_clamp_min), out_dtype, peak)


@partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
def resize_plane_batch(
    dop: DevicePlaneOperator,
    src: jax.Array,  # (F, src_h, src_w)
    out_dtype=jnp.float32,
    peak: float | None = None,
    float_clamp_min: float | None = None,
) -> jax.Array:
    """Batched (SpMM) resize: frames share every gather and weight map."""
    fn = lambda s: finalize(apply_plane(dop, s, float_clamp_min), out_dtype, peak)
    return jax.vmap(fn)(src)
