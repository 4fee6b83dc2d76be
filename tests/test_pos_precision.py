"""Drift-free geometry mode (pos_precision='f64').

The reference accumulates positions in float32 (JincResize.cpp:524, 527);
the resulting drift fragments rational scale ratios into quasi-periodic
class sequences that fall off the phase-conv path. pos_precision='f64'
evaluates positions directly in float64 — a documented non-parity mode whose
geometry stays exactly periodic for rational ratios, so the phase-conv path
runs them. These tests pin: (a) the periodicity claim, (b) closeness to the
parity output, (c) the engine actually selected, (d) validation/cache keys.
"""

import numpy as np
import pytest

from jincresize_tpu.api import JincConfig, JincError, JincResizer, jinc_resize
from jincresize_tpu.clip import Clip, gray, random_frame
from jincresize_tpu.geometry import build_plane_geometry
from jincresize_tpu.operator import build_plane_operator, radius_for_tap
from jincresize_tpu.phase import plan_phases

# 1.5x upscale with sub-pixel crop: f32 drift makes it quasi-periodic (the
# phase planner rejects it), f64 is exactly periodic with p=(3,3).
GEO = dict(
    src_width=1280,
    src_height=720,
    dst_width=1920,
    dst_height=1080,
    radius=radius_for_tap(8),
    crop_left=0.123,
    crop_top=0.456,
)


def test_f64_axis_classes_exactly_periodic():
    g = build_plane_geometry(
        src_width=1280,
        src_height=720,
        dst_width=1920,
        dst_height=1080,
        radius=radius_for_tap(8),
        crop_left=0.123,
        crop_top=0.456,
        crop_width=1280.0,
        crop_height=720.0,
        quantize_x=256,
        quantize_y=256,
        pos_dtype="f64",
    )
    # Interior classes cycle with period 3 (ratio 3/2), starts advance by 2.
    c = g.x.qclass[32:-32]
    s = g.x.start[32:-32]
    k = np.arange(len(c))
    assert (c == c[k % 3]).all()
    assert (s == s[k % 3] + (k // 3) * 2).all()


def test_f64_operator_periodic_f32_not():
    op32 = build_plane_operator(**GEO)
    op64 = build_plane_operator(**GEO, pos_precision="f64")
    assert plan_phases(op32) is None  # drift fragments the pattern
    plan = plan_phases(op64)
    assert plan is not None
    assert (plan.y.p, plan.x.p) == (3, 3)
    assert len(plan.x.exceptions) == 0 and len(plan.y.exceptions) == 0
    # Dictionary collapses from the drift-fragmented set to p x p classes.
    assert op64.pair_blocks.shape[:2] == (3, 3)
    assert op32.pair_blocks.shape[0] > 3 and op32.pair_blocks.shape[1] > 3


def test_f64_pos_precision_none_is_parity():
    op_default = build_plane_operator(**GEO)
    op_none = build_plane_operator(**GEO, pos_precision=None)
    np.testing.assert_array_equal(op_default.start_x, op_none.start_x)
    np.testing.assert_array_equal(op_default.cx_idx, op_none.cx_idx)
    np.testing.assert_array_equal(op_default.pair_blocks, op_none.pair_blocks)


def _clip(w, h, n=1, seed=0):
    return Clip.from_frames([random_frame(gray(8), w, h, seed=seed + i) for i in range(n)])


def test_f64_close_to_parity_and_uses_conv():
    # Small 1.5x geometry with crop; CPU backend -> conv path is 'shift'.
    clip = _clip(320, 240)
    kw = dict(src_left=0.123, src_top=0.456, tap=4)
    out32 = jinc_resize(clip, 480, 360, **kw)
    out64 = jinc_resize(clip, 480, 360, pos_precision="f64", **kw)
    a = out32.frames[0].planes["Y"].astype(np.int64)
    b = out64.frames[0].planes["Y"].astype(np.int64)
    d = np.abs(a - b)
    # Non-parity where drift flipped a class: adjacent quantization classes
    # give near-identical coefficient blocks, so u8 outputs differ by at
    # most a couple of LSB on a tiny fraction of pixels.
    assert d.max() <= 2
    assert (d > 0).mean() < 0.05

    r = JincResizer(clip.format, 320, 240,
                    JincConfig(target_width=480, target_height=360,
                               pos_precision="f64", **kw))
    assert r.engines["luma"] == "shift"  # conv path selected


def test_f64_impl_conv_accepts_quasi_periodic():
    # impl='conv' on this geometry errors under parity positions but works
    # under f64 (the whole point of the mode).
    clip = _clip(1280, 720)
    with pytest.raises(JincError, match="impl='conv' requires periodic"):
        jinc_resize(clip, 1920, 1080, src_left=0.123, src_top=0.456,
                    tap=8, impl="conv")
    out = jinc_resize(clip, 1920, 1080, src_left=0.123, src_top=0.456,
                      tap=8, impl="conv", pos_precision="f64")
    assert out.frames[0].planes["Y"].shape == (1080, 1920)


def test_f64_golden_consistency():
    # Both engines consume the same f64 operator: XLA path output must match
    # the host golden bit-for-bit on integer formats.
    from jincresize_tpu import apply_xla
    from jincresize_tpu.golden import apply_plane_numpy

    op = build_plane_operator(
        src_width=96, src_height=64, dst_width=144, dst_height=96,
        radius=radius_for_tap(3), crop_left=0.2, crop_top=0.1,
        pos_precision="f64")
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, size=(64, 96), dtype=np.uint8)
    ref = apply_plane_numpy(op, src, out_dtype=np.uint8, peak=255)
    dop = apply_xla.to_device(op)
    out = np.asarray(apply_xla.resize_plane(dop, src, out_dtype=np.uint8, peak=255))
    np.testing.assert_array_equal(ref, out)


def test_drift_hint_logged(caplog):
    # Quasi-periodic parity geometry on CPU lands on 'xla'; the resizer
    # logs that pos_precision='f64' would lift it onto the conv path.
    import logging

    with caplog.at_level(logging.INFO, logger="jincresize_tpu"):
        r = JincResizer(gray(8), 1280, 720,
                        JincConfig(target_width=1920, target_height=1080,
                                   src_left=0.123, src_top=0.456, tap=8))
    assert r.engines["luma"] == "xla"
    assert any("pos_precision='f64'" in m for m in caplog.messages)


def test_pos_precision_validation_and_cache_key():
    with pytest.raises(JincError, match="unknown pos_precision"):
        JincResizer(gray(8), 32, 24,
                    JincConfig(target_width=48, target_height=36,
                               pos_precision="f16"))
    from jincresize_tpu.cache import geometry_key

    base = dict(src_width=64, src_height=48, dst_width=96, dst_height=72)
    assert geometry_key(**base) != geometry_key(**base, pos_precision="f64")
