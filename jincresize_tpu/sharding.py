"""Multi-chip spatial partitioning: row-sharded apply with halo exchange.

New capability relative to the reference (SURVEY.md §2 parallelism table: the
plugin never tiles a plane across memory domains). Destination rows are
partitioned across a device mesh axis; each device owns a contiguous source
row band and receives the ``filter_size``-adjacent halo rows from its
neighbors via ``lax.ppermute`` (NCCL over NVLink between the cards of one
host), overlapped with compute by XLA's scheduler. Frames batch over a separate data axis (SpMM).

For the sharded path the operator is flattened to the *uniform* form: one
block table ``blocks_all[NB, fs, fs]`` (interior dictionary + border strips
concatenated) plus a per-pixel block-id map, so the kernel has no
border special cases and every array shards cleanly by destination rows.

Halo sizes are computed on the host from ``start_y``. Geometries whose support
exceeds one neighbor band (deep downscales) collect the halo with multi-hop
``ppermute`` chains (hop *i* ships a band *i* devices over); the source is
fully replicated via ``all_gather`` only when ``hops_up + hops_dn + 1 >=
n_devices``, where the hop chain would touch the whole mesh anyway and a
single collective is cheaper.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .apply_conv import phase_interior
from .apply_xla import finalize, tap_sum, varying_zeros
from .operator import PlaneOperator
from .phase import build_conv_kernels, select_engine

f32 = jnp.float32


def build_uniform(op: PlaneOperator) -> tuple[np.ndarray, np.ndarray]:
    """Flatten the operator to (blocks_all[NB, fs, fs], bid[dst_h, dst_w]).

    Interior pixels index the pair dictionary; border pixels index their
    per-pixel strip blocks appended after it.
    """
    fs = op.filter_size
    n_uy, n_ux = op.pair_blocks.shape[:2]
    parts = [op.pair_blocks.reshape(-1, fs, fs)]
    bid = np.zeros((op.dst_height, op.dst_width), dtype=np.int32)
    if n_uy and n_ux:
        inter = (
            op.cy_idx[op.y_lo : op.y_hi][:, None] * n_ux
            + op.cx_idx[op.x_lo : op.x_hi][None, :]
        )
        bid[op.y_lo : op.y_hi, op.x_lo : op.x_hi] = inter
    offset = n_uy * n_ux
    for s in op.strips:
        ny, nx = s.blocks.shape[:2]
        bid[s.y0 : s.y1, s.x0 : s.x1] = offset + np.arange(ny * nx).reshape(ny, nx)
        parts.append(s.blocks.reshape(-1, fs, fs))
        offset += ny * nx
    blocks_all = (
        np.concatenate(parts, axis=0)
        if parts
        else np.zeros((1, fs, fs), dtype=np.float32)
    )
    if blocks_all.shape[0] == 0:
        blocks_all = np.zeros((1, fs, fs), dtype=np.float32)
    return blocks_all.astype(np.float32), bid


@dataclass(frozen=True)
class ShardPlan:
    """Host-computed static partitioning of one plane geometry over N devices."""

    n_devices: int
    dst_rows_per: int  # padded destination rows per device
    src_rows_per: int  # padded source rows per device
    halo_up: int  # rows received from the previous device
    halo_dn: int  # rows received from the next device
    replicate_src: bool  # fallback: halo hops would cover the whole mesh
    dst_pad: int
    src_pad: int
    # ppermute hops needed to collect each halo; must stay consistent with
    # halo_up/halo_dn (0 when the halo is 0), so no defaults are provided.
    hops_up: int
    hops_dn: int


def plan_row_shard(op: PlaneOperator, n_devices: int) -> ShardPlan:
    """Compute halo sizes for an even row partition of dst and src."""
    dst_h, src_h = op.dst_height, op.src_height
    fs = op.filter_size
    td = -(-dst_h // n_devices)
    ts = -(-src_h // n_devices)
    dst_pad = td * n_devices - dst_h
    src_pad = ts * n_devices - src_h
    halo_up = 0
    halo_dn = 0
    start_y = op.start_y
    for d in range(n_devices):
        r0, r1 = d * td, min((d + 1) * td, dst_h)
        if r0 >= r1:
            continue
        lo = int(start_y[r0:r1].min())
        hi = int(start_y[r0:r1].max()) + fs
        halo_up = max(halo_up, d * ts - lo)
        halo_dn = max(halo_dn, hi - (d + 1) * ts)
    halo_up = max(halo_up, 0)
    halo_dn = max(halo_dn, 0)
    # Deep downscales need halos spanning several neighbor bands: collect
    # them with hops_{up,dn} ppermute hops (ROADMAP item 7 — multi-hop halo).
    # Replicate on a BYTE break-even, not a hop count: ppermute ships
    # halo_up+halo_dn rows per device while all_gather ships the other
    # devices' (n-1)*ts rows, so replication only wins when the halos would
    # collect at least that much anyway. The former hop-count heuristic
    # (hops_up + hops_dn + 1 >= n) overfired at n=2 — any upscale has both
    # halos nonzero, so 2-device meshes ALWAYS replicated and could never
    # reach the conv interior. Reference analog: adding a thread never
    # changes kernel choice (JincResize.cpp:596-598).
    hops_up = -(-halo_up // ts) if halo_up else 0
    hops_dn = -(-halo_dn // ts) if halo_dn else 0
    replicate = halo_up + halo_dn >= (n_devices - 1) * ts
    return ShardPlan(
        n_devices=n_devices,
        dst_rows_per=td,
        src_rows_per=ts,
        halo_up=halo_up,
        halo_dn=halo_dn,
        replicate_src=replicate,
        dst_pad=dst_pad,
        src_pad=src_pad,
        hops_up=hops_up,
        hops_dn=hops_dn,
    )


def _local_apply(
    band: jax.Array,  # (band_h, W) local source band (with halos)
    rows_local: jax.Array,  # (td,) local window start rows into band
    start_x: jax.Array,  # (dst_w,)
    bid_local: jax.Array,  # (td, dst_w)
    blocks_all: jax.Array,  # (NB, fs, fs)
    fs: int,
) -> jax.Array:
    band_h, W = band.shape
    NB = blocks_all.shape[0]

    def body(acc, k):
        ly = k // fs
        lx = k % fs
        rows = jnp.clip(rows_local + ly, 0, band_h - 1)
        cols = jnp.clip(start_x + lx, 0, W - 1)
        sv = band[rows[:, None], cols[None, :]]
        pane = jax.lax.dynamic_slice(blocks_all, (0, ly, lx), (NB, 1, 1))[:, 0, 0]
        wv = pane[bid_local]
        return (acc + sv * wv).astype(jnp.float32), None

    acc0 = varying_zeros(bid_local.shape, band, rows_local, start_x, bid_local)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(fs * fs, dtype=jnp.int32))
    return acc


def _patch_rows_sliced(band, sy_rows, start_x, bid_rows, blocks_all, fs):
    """Patch-row values (k, dst_w) via sliced windows.

    Replaces the fs^2-step per-element scan-gather (_local_apply) with bulk
    window slices: one (fs, W) dynamic_slice per patch row, one (k*fs, fs)
    column-window slice per destination column (vmap-of-dynamic_slice
    lowers to wide-slice gathers), and one contiguous fs*fs block gather
    per pixel.
    """
    band_h, W = band.shape
    k = sy_rows.shape[0]
    slab = jax.vmap(
        lambda r0: jax.lax.dynamic_slice(band, (r0, 0), (fs, W))
    )(sy_rows)  # (k, fs, W)
    slab2 = slab.reshape(k * fs, W)
    G = jax.vmap(
        lambda c0: jax.lax.dynamic_slice(slab2, (0, c0), (k * fs, fs)),
        out_axes=1,
    )(start_x)  # (k*fs, dst_w, fs)
    G = G.reshape(k, fs, start_x.shape[0], fs)
    Wb = blocks_all[bid_rows]  # (k, dst_w, fs, fs)
    return tap_sum(jnp.moveaxis(G, 1, 0), Wb)


def _patch_cols_sliced(band, sy_all, cols_sx, bid_cols, blocks_all, fs):
    """Patch-column values (rows, ncols); ``cols_sx`` are HOST-static window
    start columns, so the horizontal windows are static slices."""
    band_h, W = band.shape
    C = len(cols_sx)
    N = jnp.stack(
        [
            jax.lax.slice(band, (0, int(sx)), (band_h, int(sx) + fs))
            for sx in cols_sx
        ],
        axis=1,
    )  # (band_h, C, fs)
    N2 = N.reshape(band_h, C * fs)
    G = jax.vmap(
        lambda r0: jax.lax.dynamic_slice(N2, (r0, 0), (fs, C * fs))
    )(sy_all)  # (rows, fs, C*fs)
    G = G.reshape(sy_all.shape[0], fs, C, fs)
    Wb = blocks_all[bid_cols]  # (rows, C, fs, fs)
    return tap_sum(jnp.moveaxis(G, 1, 0), Wb)


def make_sharded_apply(
    op: PlaneOperator,
    mesh: Mesh,
    row_axis: str = "rows",
    data_axis: str | None = None,
    impl: str = "auto",
):
    """Build a jitted sharded apply: (src [F?, src_h, src_w]) -> [F?, dst_h, dst_w].

    Returns (apply_fn, plan). ``apply_fn(src, out_dtype=..., peak=...,
    float_clamp_min=...)`` runs source clamp, resample and output conversion
    (u8/u16 round/clamp — apply_xla.finalize) INSIDE the sharded jit; the
    defaults return the raw float32 accumulator. With ``data_axis`` given, a
    leading frame axis is sharded over it (SpMM over the data dimension).

    ``impl='auto'`` uses the phase-conv interior (make_sharded_apply_conv —
    zero gathers) when phase.select_engine picks 'conv' and the halos fit,
    else the uniform gather form; 'conv'/'gather' force a path.
    ``apply_fn.info`` records which interior was compiled
    ({'interior': 'conv-shift' | 'gather-scan', ...}) — the sharded analog
    of JincResizer.engines.
    """
    if impl not in ("auto", "conv", "gather"):
        raise ValueError(f"make_sharded_apply: unknown impl {impl!r}")
    if impl != "gather":
        r = make_sharded_apply_conv(op, mesh, row_axis, data_axis)
        if r is not None:
            return r
        if impl == "conv":
            raise ValueError("sharded conv path: geometry not eligible")
    n = mesh.shape[row_axis]
    plan = plan_row_shard(op, n)
    fs = op.filter_size
    blocks_all, bid = build_uniform(op)

    td, ts = plan.dst_rows_per, plan.src_rows_per
    dst_h, src_h = op.dst_height, op.src_height

    bid_p = np.zeros((td * n, op.dst_width), dtype=np.int32)
    bid_p[:dst_h] = bid
    start_y_p = np.zeros(td * n, dtype=np.int32)
    start_y_p[:dst_h] = op.start_y

    blocks_d = jnp.asarray(blocks_all)
    bid_d = jnp.asarray(bid_p)
    start_y_d = jnp.asarray(start_y_p)
    start_x_d = jnp.asarray(op.start_x)

    hu, hd = plan.halo_up, plan.halo_dn
    axis = row_axis

    def shard_fn(src_local, start_y_local, bid_local, start_x, blocks):
        # src_local: (1?, ts, W); metadata rows local to this device.
        d = jax.lax.axis_index(axis)
        if plan.replicate_src:
            band = jax.lax.all_gather(src_local, axis, axis=0, tiled=True)
            base = jnp.int32(0)
        else:
            # Multi-hop halo collection: hop i ships a band i devices over;
            # the farthest hop ships only the remainder rows it contributes.
            # Wrap-around garbage at the mesh edges is never read: edge
            # devices' window starts stay inside the real source rows.
            parts = []
            for i in range(plan.hops_up, 0, -1):
                perm = [(s, (s + i) % n) for s in range(n)]
                rows = hu - (i - 1) * ts if i == plan.hops_up else ts
                parts.append(jax.lax.ppermute(src_local[-rows:], axis, perm))
            parts.append(src_local)
            for i in range(1, plan.hops_dn + 1):
                perm = [(s, (s - i) % n) for s in range(n)]
                rows = hd - (i - 1) * ts if i == plan.hops_dn else ts
                parts.append(jax.lax.ppermute(src_local[:rows], axis, perm))
            band = jnp.concatenate(parts, axis=0) if len(parts) > 1 else src_local
            base = d * ts - hu
        rows_local = start_y_local - base
        return _local_apply(band, rows_local, start_x, bid_local, blocks, fs)

    in_specs = (P(axis, None), P(axis), P(axis, None), P(None), P(None))
    out_specs = P(axis, None)

    # Frames vmapped INSIDE the shard: used for the data axis AND for frame
    # batches on row-only meshes — the patch/im2col gathers are INDEX-count
    # bound (a gather's cost tracks its index count, not its element count),
    # so batching frames into one call amortizes them ~F-fold.
    def shard_fn_b(src_local, start_y_local, bid_local, start_x, blocks):
        f = partial(
            shard_fn,
            start_y_local=start_y_local,
            bid_local=bid_local,
            start_x=start_x,
            blocks=blocks,
        )
        return jax.vmap(f)(src_local)

    if data_axis is not None:
        fn = jax.shard_map(
            shard_fn_b,
            mesh=mesh,
            in_specs=(P(data_axis, axis, None), P(axis), P(axis, None), P(None), P(None)),
            out_specs=P(data_axis, axis, None),
        )
        fn_frames = None
    else:
        fn = jax.shard_map(
            shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs
        )
        fn_frames = jax.shard_map(
            shard_fn_b,
            mesh=mesh,
            in_specs=(P(None, axis, None),) + in_specs[1:],
            out_specs=P(None, axis, None),
        )

    # The tables are jit ARGUMENTS, not closure constants: captured, the
    # per-pixel strip blocks (GBs at tap16 8K) would be embedded in the
    # executable.
    tables = (start_y_d, bid_d, start_x_d, blocks_d)

    @partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
    def _jitted(src, tables, out_dtype=jnp.float32, peak=None, float_clamp_min=None):
        src = src.astype(jnp.float32)
        if float_clamp_min is not None:
            src = jnp.maximum(src, jnp.float32(float_clamp_min))
        batched = src.ndim == 3
        pad_rows = ts * n - src_h
        pad_cfg = [(0, pad_rows), (0, 0)]
        if batched:
            pad_cfg = [(0, 0)] + pad_cfg
        src_p = jnp.pad(src, pad_cfg)
        use = fn_frames if (batched and fn_frames is not None) else fn
        out = use(src_p, *tables)
        return finalize(out[..., :dst_h, :], out_dtype, peak)

    def apply_fn(src, out_dtype=jnp.float32, peak=None, float_clamp_min=None):
        return _jitted(
            src, tables, out_dtype=out_dtype, peak=peak, float_clamp_min=float_clamp_min
        )

    apply_fn.info = {
        # Uniform form: an fs^2-step element-gather scan, for geometries the
        # conv interior declines (aperiodic, or halos past one neighbour).
        "interior": "gather-scan",
        "replicate_src": plan.replicate_src,
        "hops": (plan.hops_up, plan.hops_dn),
    }
    return apply_fn, plan


# ---------------------------------------------------------------------------
# Phase-conv sharded apply: shift-sum interior per device + thin patches.
# ---------------------------------------------------------------------------


def _shift_interior(seg, K_np, py, px, qy, qx, nyb_l, nxb, base_x, fs, offsets):
    """Shift-sum phase interior on a local (seg_h, W_pad) segment.

    apply_conv.phase_interior, row-local: the caller has already
    dynamic-sliced ``seg`` so block 0's window starts at row 0. Returns
    (py*nyb_l, px*nxb) in destination layout.
    """
    Kh, Kw = K_np.shape[2], K_np.shape[3]
    eh = (nyb_l - 1) * qy + Kh
    ew = (nxb - 1) * qx + Kw
    lhs = jax.lax.dynamic_slice(seg, (0, base_x), (eh, ew))
    conv = phase_interior(
        lhs, jnp.asarray(K_np[:, 0]), offsets, qy, qx, nyb_l, nxb, fs
    )
    return (
        conv.reshape(py, px, nyb_l, nxb)
        .transpose(2, 0, 3, 1)
        .reshape(py * nyb_l, px * nxb)
    )


def make_sharded_apply_conv(
    op: PlaneOperator,
    mesh: Mesh,
    row_axis: str = "rows",
    data_axis: str | None = None,
):
    """Phase-conv sharded apply; None if the geometry doesn't qualify.

    Per device: ppermute halo exchange -> dynamic-slice the local band at the
    first (possibly straddling) phase-block boundary -> static shift-sum
    interior in dst layout -> paste at a traced offset -> patch border strips,
    exception rows and exception/border columns with the uniform gather.
    The interior does zero gathers; patches touch O(fs) rows/cols.

    This is the multi-chip analog of apply_conv (SURVEY.md §2 parallelism
    table: row partitioning with tap-width halo exchange); the reference has
    no distributed mode at all.
    """
    engine, pplan = select_engine(op)
    if engine != "conv":
        return None
    n = mesh.shape[row_axis]
    splan = plan_row_shard(op, n)
    if splan.replicate_src:
        return None

    fs = op.filter_size
    py, px = pplan.y.p, pplan.x.p
    qy, qx = pplan.y.q, pplan.x.q
    nyb, nxb = pplan.y.nblocks, pplan.x.nblocks
    offs_y = pplan.y.offsets.astype(int)
    offs_x = pplan.x.offsets.astype(int)
    spread_y = int(offs_y.max())
    base_y, base_x = pplan.y.base, pplan.x.base
    ylo, xlo = pplan.y.lo, pplan.x.lo
    yhi = ylo + py * nyb
    xhi = xlo + px * nxb
    dst_h, dst_w, src_h = op.dst_height, op.dst_width, op.src_height
    td, ts = splan.dst_rows_per, splan.src_rows_per

    # Guards: device 0 must own the whole top border, the interior must be
    # tall enough for the straddling-block slack.
    if td < max(ylo, py, fs) or nyb < 3:
        return None

    # Halo with extra margin so the straddler block's window start is >= 0.
    hu = splan.halo_up + spread_y + qy
    hd = splan.halo_dn + spread_y + qy
    if hu > ts or hd > ts:
        return None

    K_np = build_conv_kernels(op, pplan)
    Kw = K_np.shape[3]
    nyb_l = td // py + 2  # blocks computed per device (covers straddlers)
    seg_h = qy * (nyb_l - 1) + spread_y + fs
    ew_req = base_x + (nxb - 1) * qx + Kw  # columns the interior reads

    offsets = tuple(
        (int(offs_y[ry]), int(offs_x[rx])) for ry in range(py) for rx in range(px)
    )

    blocks_all, bid = build_uniform(op)

    # Patch rows per device: strips + y-exceptions owned by each device.
    exc_y = set(int(v) for v in pplan.y.exceptions)
    patch_rows_per_dev = []
    for d in range(n):
        r0, r1 = d * td, min((d + 1) * td, dst_h)
        rows = [r for r in range(r0, r1) if r < ylo or r >= yhi or r in exc_y]
        patch_rows_per_dev.append(rows)
    k_max = max(1, max(len(r) for r in patch_rows_per_dev))
    idx_rows = np.zeros((n, k_max), dtype=np.int32)
    for d, rows in enumerate(patch_rows_per_dev):
        fill = rows if rows else [min(d * td, dst_h - 1)]
        for k in range(k_max):
            idx_rows[d, k] = fill[k] if k < len(fill) else fill[-1]

    # Patch columns (same set on every device): border + x-exceptions.
    cols = sorted(
        set(range(0, xlo))
        | set(range(xhi, dst_w))
        | set(int(v) for v in pplan.x.exceptions)
    )
    cols_np = np.asarray(cols if cols else [0], dtype=np.int32)
    cols_sx = [int(v) for v in op.start_x[cols_np]]  # host-static col starts

    start_y_p = np.zeros(td * n, dtype=np.int32)
    start_y_p[:dst_h] = op.start_y
    bid_p = np.zeros((td * n, dst_w), dtype=np.int32)
    bid_p[:dst_h] = bid

    blocks_d = jnp.asarray(blocks_all)
    start_x_d = jnp.asarray(op.start_x)
    bid_cols_d = jnp.asarray(bid_p[:, cols_np])  # (td*n, ncols)
    start_y_d = jnp.asarray(start_y_p)  # (td*n,)
    idx_rows_d = jnp.asarray(idx_rows.reshape(n * k_max))  # shard by rows
    sy_rows_d = jnp.asarray(op.start_y[idx_rows.reshape(-1)])
    bid_rows_d = jnp.asarray(bid[idx_rows.reshape(-1)])  # (n*k_max, dst_w)

    ext_h = td + ylo + py * (nyb_l + 2)
    cols_j = jnp.asarray(cols_np)
    axis = row_axis

    def shard_fn(
        src_local,  # (ts, W)
        start_y_local,  # (td,)
        bid_cols_local,  # (td, ncols)
        idx_rows_local,  # (k_max,)
        sy_rows_local,  # (k_max,)
        bid_rows_local,  # (k_max, dst_w)
        start_x,
        blocks,
    ):
        d = jax.lax.axis_index(axis)
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        parts = []
        if hu > 0:
            parts.append(jax.lax.ppermute(src_local[-hu:], axis, fwd))
        parts.append(src_local)
        if hd > 0:
            parts.append(jax.lax.ppermute(src_local[:hd], axis, bwd))
        band = jnp.concatenate(parts, axis=0) if len(parts) > 1 else src_local
        band_start = d * ts - hu

        # Interior: dynamic-slice the segment at the straddler block, then
        # everything below is static.
        bi0 = jnp.maximum(0, (d * td - ylo) // py)
        pad_w = max(0, ew_req - band.shape[1])
        band_p = jnp.pad(band, ((0, seg_h), (0, pad_w)))
        seg_off = base_y + qy * bi0 - band_start
        seg = jax.lax.dynamic_slice(
            band_p, (seg_off, 0), (seg_h, band.shape[1] + pad_w)
        )
        block = _shift_interior(
            seg, K_np, py, px, qy, qx, nyb_l, nxb, base_x, fs, offsets
        )

        canvas = jnp.zeros((ext_h, dst_w), dtype=f32)
        paste_o = ylo + py * bi0 - d * td + py
        canvas = jax.lax.dynamic_update_slice(
            canvas,
            block[: ext_h - py, :],
            (paste_o, xlo),
        )
        canvas = jax.lax.slice(canvas, (py, 0), (py + td, dst_w))

        # Patch rows (strips + y-exceptions) and columns (strips +
        # x-exceptions): sliced-window forms, not the fs^2-step scan-gather.
        vals_r = _patch_rows_sliced(
            band, sy_rows_local - band_start, start_x, bid_rows_local, blocks, fs
        )
        canvas = canvas.at[idx_rows_local - d * td].set(vals_r)
        vals_c = _patch_cols_sliced(
            band, start_y_local - band_start, cols_sx, bid_cols_local, blocks, fs
        )
        canvas = canvas.at[:, cols_j].set(vals_c)
        return canvas

    in_specs = (
        P(axis, None),
        P(axis),
        P(axis, None),
        P(axis),
        P(axis),
        P(axis, None),
        P(None),
        P(None),
    )

    def shard_fn_b(src_local, *rest):
        return jax.vmap(lambda s: shard_fn(s, *rest))(src_local)

    if data_axis is not None:
        fn = jax.shard_map(
            shard_fn_b,
            mesh=mesh,
            in_specs=(P(data_axis, axis, None),) + in_specs[1:],
            out_specs=P(data_axis, axis, None),
        )
        fn_frames = None
    else:
        fn = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=P(axis, None),
        )
        # Frame batches on a row-only mesh: vmap INSIDE the shard so the
        # index-bound patch/im2col gathers amortize over the batch.
        fn_frames = jax.shard_map(
            shard_fn_b,
            mesh=mesh,
            in_specs=(P(None, axis, None),) + in_specs[1:],
            out_specs=P(None, axis, None),
        )

    # Jit arguments, not closure constants (see make_sharded_apply).
    tables = (
        start_y_d,
        bid_cols_d,
        idx_rows_d,
        sy_rows_d,
        bid_rows_d,
        start_x_d,
        blocks_d,
    )

    @partial(jax.jit, static_argnames=("out_dtype", "peak", "float_clamp_min"))
    def _jitted(src, tables, out_dtype=jnp.float32, peak=None, float_clamp_min=None):
        src = src.astype(f32)
        if float_clamp_min is not None:
            src = jnp.maximum(src, jnp.float32(float_clamp_min))
        batched = src.ndim == 3
        pad_rows = ts * n - src_h
        pad_cfg = [(0, pad_rows), (0, 0)]
        if batched:
            pad_cfg = [(0, 0)] + pad_cfg
        src_p = jnp.pad(src, pad_cfg)
        use = fn_frames if (batched and fn_frames is not None) else fn
        out = use(src_p, *tables)
        return finalize(out[..., :dst_h, :], out_dtype, peak)

    def apply_fn(src, out_dtype=jnp.float32, peak=None, float_clamp_min=None):
        return _jitted(
            src, tables, out_dtype=out_dtype, peak=peak, float_clamp_min=float_clamp_min
        )

    apply_fn.info = {
        "interior": "conv-shift",
        "replicate_src": False,
        "hops": (1 if hu > 0 else 0, 1 if hd > 0 else 0),
    }
    return apply_fn, splan


class ShardedApplier:
    """Multi-chip applier: row-sharded resample with in-jit output conversion.

    Interface-compatible with apply_conv.ConvApplier so ``JincResizer`` can
    route planes through a device mesh (``impl='sharded'`` / ``mesh=...``):
    call with (H, W) or (F, H, W) sources and output dtype/peak/clamp;
    everything — source clamp, halo exchange, interior, border patches,
    u8/u16 round/clamp — runs inside one sharded jit. Frame batches shard
    over the mesh's ``data`` axis when present (padded up to a multiple of
    its size), rows always shard over ``rows``.

    ``self.interior`` reports which interior was compiled ('conv-shift' or
    'gather-scan').
    """

    def __init__(self, op: PlaneOperator, mesh: Mesh, impl: str = "auto"):
        if "rows" not in mesh.axis_names:
            raise ValueError("ShardedApplier: mesh needs a 'rows' axis")
        self.op = op
        self.mesh = mesh
        self._fn_single, self.plan = make_sharded_apply(op, mesh, impl=impl)
        self._fn_batch = None
        self._n_data = 1
        if "data" in mesh.axis_names:
            self._fn_batch, _ = make_sharded_apply(
                op, mesh, data_axis="data", impl=impl
            )
            self._n_data = mesh.shape["data"]
        self.info = dict(self._fn_single.info)
        self.interior = self.info["interior"]

    def __call__(
        self, src, out_dtype=jnp.float32, peak=None, float_clamp_min=None
    ):
        kw = dict(out_dtype=out_dtype, peak=peak, float_clamp_min=float_clamp_min)
        if src.ndim == 2:
            return self._fn_single(src, **kw)
        if self._fn_batch is None:
            # Row-only mesh: the makers vmap frames INSIDE the shard —
            # one call for the whole batch amortizes the index-bound patch
            # gathers, where per-frame calls paid them F times.
            return self._fn_single(src, **kw)
        F = src.shape[0]
        pad = -F % self._n_data
        if pad:
            src = jnp.concatenate([src, jnp.repeat(src[-1:], pad, axis=0)])
        out = self._fn_batch(src, **kw)
        return out[:F] if pad else out


def make_mesh(
    n_rows: int | None = None, n_data: int = 1, devices=None
) -> Mesh:
    """Create a ('data', 'rows') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_rows is None:
        n_rows = len(devices) // n_data
    devs = np.asarray(devices[: n_data * n_rows]).reshape(n_data, n_rows)
    return Mesh(devs, ("data", "rows"))
