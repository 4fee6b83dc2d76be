"""Engine selection and the paths that replaced the removed engines.

One function (phase.select_engine) decides the engine from the geometry
alone; drifted and aperiodic geometries run the XLA gather path under
impl='auto'; the removed impl values are unknown to the API and the CLI.
"""

import numpy as np
import pytest

from jincresize_tpu.golden import apply_plane_numpy
from jincresize_tpu.operator import build_plane_operator, radius_for_tap

# (id, (sw, sh, dw, dh), tap, builder kwargs, expected engine)
GEOMETRY_CLASSES = [
    ("periodic-2x-up", (64, 48, 128, 96), 8, {}, "conv"),
    ("periodic-2/3-down", (90, 60, 60, 40), 4, {}, "conv"),
    ("periodic-5/2-exceptions", (160, 120, 400, 300), 3, {}, "conv"),
    ("deep-tap16-down", (480, 270, 240, 135), 16, {}, "conv"),
    ("drifted-1.5x", (640, 360, 960, 540), 8, {}, "xla"),
    (
        "drifted-1.5x-f64",
        (640, 360, 960, 540),
        8,
        {"crop_left": 0.123, "crop_top": 0.456, "pos_precision": "f64"},
        "conv",
    ),
    ("aperiodic", (96, 64, 167, 113), 3, {}, "xla"),
]


@pytest.mark.parametrize(
    "name,geo,tap,kw,engine",
    GEOMETRY_CLASSES,
    ids=[g[0] for g in GEOMETRY_CLASSES],
)
def test_select_engine_geometry_classes(name, geo, tap, kw, engine):
    """select_engine decides from the geometry; api._select_engine and the
    sharded maker follow it."""
    from jincresize_tpu.api import _select_engine
    from jincresize_tpu.phase import select_engine

    op = build_plane_operator(*geo, radius_for_tap(tap), **kw)
    got, plan = select_engine(op)
    assert got == engine
    assert (plan is not None) == (engine == "conv")
    app, name_ = _select_engine(op, "auto", "fp32")
    assert name_ == ("shift" if engine == "conv" else "xla")
    assert (app is None) == (engine == "xla")


# Geometries the removed segment-periodic and gather engines served: the
# drifted 1.5x and 2.5x-with-exceptions scales, and aperiodic ratios.
DRIFTED_AND_APERIODIC = [
    ("drifted-1.5x-tap8", (640, 360, 960, 540), 8),
    ("drifted-2.5x-exceptions", (1920, 80, 4800, 200), 2),
    ("aperiodic-up", (96, 64, 167, 113), 3),
    ("aperiodic-down", (120, 80, 77, 53), 2),
    ("aperiodic-wide", (400, 220, 601, 331), 3),
]


@pytest.mark.parametrize("bits", [8, 32], ids=["u8", "f32"])
@pytest.mark.parametrize(
    "name,geo,tap",
    DRIFTED_AND_APERIODIC,
    ids=[g[0] for g in DRIFTED_AND_APERIODIC],
)
def test_auto_parity_drifted_and_aperiodic(name, geo, tap, bits):
    """impl='auto' runs these on the XLA path, at parity with the golden."""
    from jincresize_tpu.api import JincConfig, JincResizer
    from jincresize_tpu.clip import Clip, gray, random_frame

    sw, sh, dw, dh = geo
    fmt = gray(bits)
    clip = Clip.from_frames([random_frame(fmt, sw, sh, seed=3)])
    r = JincResizer(fmt, sw, sh, JincConfig(dw, dh, tap=tap), frame0=clip.frames[0])
    assert r.engines == {"luma": "xla"}
    out = r(clip).frames[0].planes["Y"]
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
    src = clip.frames[0].planes["Y"]
    if bits == 8:
        ref = apply_plane_numpy(op, src, out_dtype=np.uint8, peak=255.0)
        assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= 1
    else:
        ref = apply_plane_numpy(op, src, float_clamp_min=0.0)
        assert float(np.abs(out - ref).max()) <= 2e-6


@pytest.mark.parametrize("impl", ["seg", "gather", "pallas"])
def test_removed_impl_rejected_by_api(impl):
    from jincresize_tpu.api import JincError, jinc_resize
    from jincresize_tpu.clip import Clip, gray, random_frame

    clip = Clip.from_frames([random_frame(gray(8), 32, 24, seed=1)])
    with pytest.raises(JincError, match="unknown impl"):
        jinc_resize(clip, 48, 36, impl=impl)


@pytest.mark.parametrize("impl", ["seg", "gather", "pallas"])
def test_removed_impl_rejected_by_cli(impl, tmp_path, capsys):
    from jincresize_tpu.cli import main

    src = np.zeros((24, 32), dtype=np.uint8)
    inp = tmp_path / "in.npy"
    np.save(inp, src)
    with pytest.raises(SystemExit) as e:
        main([str(inp), str(tmp_path / "out.npy"), "--width", "48",
              "--height", "36", "--impl", impl])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_deep_scan_offset_group_matches_unrolled(monkeypatch):
    """An offset-grouped deep-tap plan: each group's scan reads a window
    wider than its own taps need (offset by its embedding), and matches the
    unrolled shift-sum."""
    import jax.numpy as jnp

    from jincresize_tpu import apply_conv

    fs, qy, qx, nyb, nxb = 6, 1, 1, 16, 128
    offsets = ((0, 0), (0, 5))  # two groups; Kh*Kw > 1.3*fs^2
    Kh, Kw = fs, fs + 5
    rng = np.random.default_rng(4)
    K = np.zeros((2, Kh, Kw), np.float32)
    for p, (oy, ox) in enumerate(offsets):
        blk = rng.random((fs, fs), dtype=np.float32)
        K[p, oy : oy + fs, ox : ox + fs] = blk / blk.sum()
    lhs = jnp.asarray(
        rng.random(((nyb - 1) * qy + Kh, (nxb - 1) * qx + Kw), dtype=np.float32)
    )
    args = (lhs, jnp.asarray(K), offsets, qy, qx, nyb, nxb, fs)
    ref = np.asarray(apply_conv.phase_interior(*args))  # unrolled
    monkeypatch.setattr(apply_conv, "SHIFT_UNROLL_MAX", 16)
    out = np.asarray(apply_conv.phase_interior(*args))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
