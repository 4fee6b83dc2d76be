"""API-layer tests: validation messages, cplace resolution, aliases, props."""

import numpy as np
import pytest

from jincresize_tpu.api import (
    JincConfig,
    JincError,
    JincResizer,
    jinc36_resize,
    jinc256_resize,
    jinc_resize,
)
from jincresize_tpu.clip import (
    Clip,
    gray,
    random_frame,
    rgbp,
    yuv420p,
    yuv422p,
    yuv444p,
)


def _clip(fmt, w=32, h=24, n=1, seed=0, props=None):
    return Clip.from_frames(
        [random_frame(fmt, w, h, seed=seed + i, props=props) for i in range(n)]
    )


# ------------------------------------------------------------------ validation
@pytest.mark.parametrize(
    "kw,msg",
    [
        (dict(tap=0), "JincResize: tap must be between 1..16."),
        (dict(tap=17), "JincResize: tap must be between 1..16."),
        (dict(quant_x=0), "JincResize: quant_x must be between 1..256."),
        (dict(quant_y=300), "JincResize: quant_y must be between 1..256."),
        (dict(opt=4), "JincResize: opt higher than 3 is not allowed."),
        (dict(threads=2), "JincResize: threads must be either 0 or 1."),
        (
            dict(initial_factor=0.5),
            "JincResize: initial_factor must be eqaul to or greater than 1.0.",
        ),
        (
            dict(initial_capacity=0),
            "JincResize: initial_capacity must be greater than 0.",
        ),
        (
            dict(cplace="center"),
            "JincResize: cplace must be MPEG2, MPEG1 or topleft.",
        ),
    ],
)
def test_validation_messages(kw, msg):
    clip = _clip(gray())
    with pytest.raises(JincError, match=msg.replace("(", "\\(").replace(")", "\\)")):
        jinc_resize(clip, 48, 36, impl="numpy", **kw)


def test_topleft_requires_420():
    clip = _clip(yuv422p())
    with pytest.raises(JincError, match="topleft must be used only for 4:2:0"):
        jinc_resize(clip, 48, 36, cplace="topleft", impl="numpy")


# ---------------------------------------------------------------- cplace/props
def test_cplace_from_frame_prop():
    clip = _clip(yuv420p(), props={"_ChromaLocation": 1})
    cfg = JincConfig(target_width=48, target_height=36, impl="numpy")
    r = JincResizer(clip.format, clip.width, clip.height, cfg, frame0=clip.frames[0])
    assert r.cplace == "mpeg1"


def test_cplace_default_mpeg2():
    clip = _clip(yuv420p())
    cfg = JincConfig(target_width=48, target_height=36, impl="numpy")
    r = JincResizer(clip.format, clip.width, clip.height, cfg, frame0=clip.frames[0])
    assert r.cplace == "mpeg2"


def test_invalid_chromalocation_prop():
    clip = _clip(yuv420p(), props={"_ChromaLocation": 5})
    with pytest.raises(JincError, match="invalid _ChromaLocation"):
        jinc_resize(clip, 48, 36, impl="numpy")


def test_output_prop_written():
    clip = _clip(yuv420p())
    out = jinc_resize(clip, 48, 36, cplace="topleft", impl="numpy")
    assert out.frames[0].props["_ChromaLocation"] == 2
    out444 = jinc_resize(_clip(yuv444p()), 48, 36, impl="numpy")
    assert "_ChromaLocation" not in out444.frames[0].props


# -------------------------------------------------------------------- aliases
def test_alias_pins_tap():
    clip = _clip(gray())
    a = jinc36_resize(clip, 40, 30, impl="numpy")
    b = jinc_resize(clip, 40, 30, tap=3, impl="numpy")
    np.testing.assert_array_equal(a.frames[0].planes["Y"], b.frames[0].planes["Y"])
    c = jinc256_resize(clip, 40, 30, impl="numpy")
    d = jinc_resize(clip, 40, 30, tap=8, impl="numpy")
    np.testing.assert_array_equal(c.frames[0].planes["Y"], d.frames[0].planes["Y"])
    assert not np.array_equal(
        a.frames[0].planes["Y"], c.frames[0].planes["Y"]
    )


# ---------------------------------------------------------------- crop surface
def test_negative_src_width_is_right_crop():
    clip = _clip(gray(), w=40, h=30)
    # src_width=-4 crops 4 columns from the right: equals src_width=36-left.
    a = jinc_resize(clip, 48, 36, src_left=2.0, src_width=-4.0, impl="numpy")
    b = jinc_resize(clip, 48, 36, src_left=2.0, src_width=34.0, impl="numpy")
    np.testing.assert_array_equal(a.frames[0].planes["Y"], b.frames[0].planes["Y"])


def test_blur_zero_means_one():
    clip = _clip(gray())
    a = jinc_resize(clip, 40, 30, blur=0.0, impl="numpy")
    b = jinc_resize(clip, 40, 30, blur=1.0, impl="numpy")
    np.testing.assert_array_equal(a.frames[0].planes["Y"], b.frames[0].planes["Y"])


# ------------------------------------------------------------------- formats
@pytest.mark.parametrize(
    "fmt",
    [
        gray(8),
        yuv420p(8),
        yuv422p(10),
        yuv444p(16),
        rgbp(8),
        yuv420p(8, alpha=True),
        rgbp(32),
    ],
    ids=lambda f: f"{f.family}{f.sub_w}{f.sub_h}-{f.bits}{'a' if f.has_alpha else ''}",
)
def test_format_roundtrip_shapes(fmt):
    clip = _clip(fmt, w=32, h=24)
    out = jinc_resize(clip, 48, 36, impl="numpy")
    f = out.frames[0].validate()
    assert f.width == 48 and f.height == 36
    for name in fmt.plane_names:
        pw, ph = fmt.plane_dims(name, 48, 36)
        assert f.planes[name].shape == (ph, pw)


def test_dc_all_planes_420():
    fmt = yuv420p(8)
    planes = {
        "Y": np.full((24, 32), 100, np.uint8),
        "U": np.full((12, 16), 64, np.uint8),
        "V": np.full((12, 16), 190, np.uint8),
    }
    from jincresize_tpu.clip import Frame

    clip = Clip.from_frames([Frame(format=fmt, planes=planes)])
    out = jinc_resize(clip, 64, 48, impl="numpy").frames[0]
    assert (out.planes["Y"] == 100).all()
    assert (out.planes["U"] == 64).all()
    assert (out.planes["V"] == 190).all()


def test_precision_validation():
    clip = _clip(yuv420p(8))
    with pytest.raises(JincError, match="unknown precision"):
        jinc_resize(clip, 64, 48, precision="fp16")


def test_precision_bf16_plumbs_and_runs():
    """precision='bf16' is accepted and validated; every engine runs full
    float32 math, so the effective precision is 'fp32' and the result
    matches the golden."""
    from jincresize_tpu.apply_conv import ConvApplier
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap

    op = build_plane_operator(32, 24, 64, 48, radius_for_tap(3))
    a = ConvApplier(op, precision="bf16")
    assert a.precision == "bf16"
    assert a.effective_precision == "fp32"
    with pytest.raises(ValueError, match="unknown precision"):
        ConvApplier(op, precision="fp16")
    clip = _clip(yuv420p(8))
    out = jinc_resize(clip, 64, 48, precision="bf16").frames[0]
    ref = jinc_resize(clip, 64, 48, impl="numpy").frames[0]
    for name in out.planes:
        d = np.abs(out.planes[name].astype(int) - ref.planes[name].astype(int))
        assert d.max() <= 1


def test_batched_clip_matches_per_frame():
    """Multi-frame clips take the batched SpMM dispatch; output must match
    the per-frame path exactly (same jitted computation under vmap)."""
    clip = _clip(yuv420p(8), n=3, seed=4, props={"_ChromaLocation": 0})
    resized = jinc_resize(clip, 64, 48)
    assert len(resized.frames) == 3
    ref = jinc_resize(clip, 64, 48, impl="numpy")
    for fb, fr in zip(resized.frames, ref.frames):
        assert fb.props.get("_ChromaLocation") == 0
        for n in fb.planes:
            d = np.abs(fb.planes[n].astype(int) - fr.planes[n].astype(int))
            assert d.max() <= 1, n
