"""Phase-conv path tests: plan detection, parity, fixups, batching."""

import numpy as np
import pytest

from jincresize_tpu.golden import apply_plane_numpy
from jincresize_tpu.operator import build_plane_operator, radius_for_tap
from jincresize_tpu.phase import plan_phases


def _parity(op, seed=0, dtype=np.float32, peak=None, tol=1e-6):
    import jax.numpy as jnp

    from jincresize_tpu import apply_conv

    cop = apply_conv.build_conv_operator(op)
    assert cop is not None
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        src = rng.random((op.src_height, op.src_width), dtype=np.float32)
    else:
        src = rng.integers(0, int(peak) + 1, (op.src_height, op.src_width)).astype(
            dtype
        )
    a = np.asarray(
        apply_conv.resize_plane_conv(cop, jnp.asarray(src), out_dtype=dtype, peak=peak)
    )
    b = apply_plane_numpy(op, src, out_dtype=dtype, peak=peak)
    if dtype == np.float32:
        assert np.abs(a - b).max() <= tol
    else:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    return cop


def test_exact_2x_upscale_no_exceptions():
    op = build_plane_operator(64, 48, 128, 96, radius_for_tap(8))
    plan = plan_phases(op)
    assert plan.x.p == 2 and plan.x.q == 1
    assert len(plan.x.exceptions) == 0 and len(plan.y.exceptions) == 0
    _parity(op)
    _parity(op, dtype=np.uint8, peak=255.0)


def test_downscale_periodic():
    op = build_plane_operator(96, 60, 64, 40, radius_for_tap(3))
    plan = plan_phases(op)
    assert plan is not None and plan.x.q > plan.x.p  # downscale advances faster
    _parity(op)


def test_drifty_case_with_exceptions():
    # 2/3-step drift: exception columns/rows must be patched correctly.
    op = build_plane_operator(320, 180, 480, 270, radius_for_tap(3))
    plan = plan_phases(op)
    assert plan is not None
    assert len(plan.x.exceptions) > 0 or len(plan.y.exceptions) > 0
    _parity(op)
    _parity(op, dtype=np.uint16, peak=1023.0)


def test_crop_periodic():
    op = build_plane_operator(
        64, 48, 96, 72, radius_for_tap(3), crop_left=1.3, crop_top=0.6
    )
    _parity(op)


def test_aperiodic_returns_none():
    op = build_plane_operator(719, 479, 1077, 717, radius_for_tap(2))
    # Either no plan, or a plan whose exceptions stay under the cap — both OK;
    # what matters is build_conv_operator not lying.
    from jincresize_tpu import apply_conv

    cop = apply_conv.build_conv_operator(op)
    if cop is not None:
        _parity(op, tol=2e-6)


def test_batch_conv():
    import jax.numpy as jnp

    from jincresize_tpu import apply_conv

    op = build_plane_operator(64, 48, 128, 96, radius_for_tap(3))
    cop = apply_conv.build_conv_operator(op)
    rng = np.random.default_rng(3)
    srcb = rng.random((3, 48, 64), dtype=np.float32)
    ab = np.asarray(apply_conv.resize_plane_conv_batch(cop, jnp.asarray(srcb)))
    bb = np.stack([apply_plane_numpy(op, s) for s in srcb])
    assert np.abs(ab - bb).max() <= 1e-6


@pytest.mark.parametrize(
    "sw,sh,dw,dh,tap",
    [
        (64, 48, 128, 96, 8),  # exact 2x up, tap 8 (the headline geometry)
        (96, 60, 64, 40, 3),  # downscale
        (90, 60, 60, 40, 4),  # 2/3 downscale (p=2, q=3)
        (64, 64, 256, 256, 3),  # 4x up (p=4, q=1)
        (40, 30, 200, 150, 3),  # 5x up (many column phases)
        (64, 48, 128, 96, 6),  # 2x up, tap 6
    ],
)
def test_shift_interior_golden_parity(sw, sh, dw, dh, tap):
    """ConvApplier's shift-sum interior + strips + fixups vs the golden."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier

    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    ap = ConvApplier(op)
    assert ap.interior == "shift"
    src = np.random.default_rng(1).random((sh, sw), dtype=np.float32)
    a = np.asarray(ap(jnp.asarray(src)))
    b = apply_plane_numpy(op, src)
    assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize(
    "crop",
    [{}, {"crop_left": 0.25, "crop_top": -0.5}],
    ids=["u8", "u8-subpixel-crop"],
)
def test_shift_interior_golden_parity_u8(crop):
    """u8 finalize through the applier, with and without a sub-pixel crop."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier

    op = build_plane_operator(64, 48, 128, 96, radius_for_tap(4), **crop)
    ap = ConvApplier(op)
    srcu = np.random.default_rng(7).integers(0, 256, (48, 64)).astype(np.uint8)
    au = np.asarray(ap(jnp.asarray(srcu), out_dtype=np.uint8, peak=255.0))
    bu = apply_plane_numpy(op, srcu, out_dtype=np.uint8, peak=255)
    assert np.abs(au.astype(int) - bu.astype(int)).max() <= 1


def test_api_auto_uses_conv():
    from jincresize_tpu.api import JincConfig, JincResizer
    from jincresize_tpu.clip import Clip, random_frame, yuv420p

    clip = Clip.from_frames([random_frame(yuv420p(8), 64, 48, seed=5)])
    cfg = JincConfig(target_width=128, target_height=96, impl="auto")
    r = JincResizer(clip.format, 64, 48, cfg, frame0=clip.frames[0])
    assert r._applier_luma is not None
    assert r.engines["luma"] == "shift"
    out = r.process_frame(clip.frames[0])
    ref = JincResizer(
        clip.format,
        64,
        48,
        JincConfig(target_width=128, target_height=96, impl="numpy"),
        frame0=clip.frames[0],
    ).process_frame(clip.frames[0])
    for n in out.planes:
        assert (
            np.abs(out.planes[n].astype(int) - ref.planes[n].astype(int)).max() <= 1
        )


def test_concat_assembly_with_exceptions():
    """Canvas assembly must apply exception fixups with the right
    precedence against the framing border strips. 160x120 -> 400x300 (5/2)
    has 14 y- and 17 x-exceptions with py*px=25."""
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier
    from jincresize_tpu.golden import apply_plane_numpy
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap

    op = build_plane_operator(160, 120, 400, 300, radius_for_tap(3))
    a = ConvApplier(op)
    assert a.cop.exc_x.shape[0] and a.cop.exc_y.shape[0]
    src = np.random.default_rng(21).random((120, 160), dtype=np.float32)
    out = np.asarray(a(jnp.asarray(src)))
    ref = apply_plane_numpy(op, src)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


def test_tap16_deep_downscale_engine_selection():
    """tap16 deep downscales (fs=65, fs^2=4225): the phase planner finds
    the trivial (p=1, q=2) pattern, so the geometry selects the conv engine,
    whose interior takes the deep-tap form past SHIFT_UNROLL_MAX; multi-
    phase deep plans (p=2 per axis, and the wider 4/5 plan) select it too."""
    from jincresize_tpu.api import _select_engine
    from jincresize_tpu.apply_conv import SHIFT_UNROLL_MAX
    from jincresize_tpu.phase import plan_phases

    op = build_plane_operator(480, 270, 240, 135, radius_for_tap(16))
    assert op.filter_size == 65
    plan = plan_phases(op)
    assert plan is not None and (plan.y.p, plan.y.q) == (1, 2)
    assert op.filter_size**2 > SHIFT_UNROLL_MAX
    op2 = build_plane_operator(480, 270, 320, 180, radius_for_tap(16))
    plan2 = plan_phases(op2)
    assert plan2 is not None and (plan2.y.p, plan2.x.p) == (2, 2)
    op3 = build_plane_operator(480, 270, 384, 216, radius_for_tap(16))
    plan3 = plan_phases(op3)
    assert plan3 is not None and plan3.y.p * plan3.x.p > 4
    for o in (op, op2, op3):
        app, engine = _select_engine(o, "auto", "fp32")
        assert engine == "shift", engine


@pytest.mark.parametrize("dst", [(240, 135), (160, 90)], ids=["0.5x", "1/3x"])
def test_tap16_downscale_scan_shift_parity(dst):
    """fs=65 (4225 taps) and, at 1/3x, fs=98 with qy=qx=3, through the
    scan-form shift-sum (_shift_sum_scan): the unrolled program at this size
    is too large to compile. Parity vs the scalar-semantics golden at the
    conv path's accumulation-order class."""
    from jincresize_tpu.apply_conv import ConvApplier

    op = build_plane_operator(480, 270, *dst, radius_for_tap(16))
    assert op.filter_size ** 2 > 2048
    app = ConvApplier(op)
    src = np.random.default_rng(9).integers(0, 256, (270, 480)).astype(np.uint8)
    out = np.asarray(app(src, out_dtype=np.uint8, peak=255.0))
    ref = apply_plane_numpy(op, src, out_dtype=np.uint8, peak=255.0)
    assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= 1
