"""Sharded apply tests on the 8-virtual-CPU-device harness (SURVEY.md §4)."""

import numpy as np
import pytest

from jincresize_tpu.golden import apply_plane_numpy
from jincresize_tpu.operator import build_plane_operator, radius_for_tap


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from jincresize_tpu.sharding import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_rows=8, n_data=1)


@pytest.fixture(scope="module")
def mesh_2x4():
    import jax

    from jincresize_tpu.sharding import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_rows=4, n_data=2)


def test_row_shard_parity_upscale(mesh8):
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    fn, plan = make_sharded_apply(op, mesh8)
    assert not plan.replicate_src
    assert plan.halo_up > 0 or plan.halo_dn > 0  # real halo exchange happened
    rng = np.random.default_rng(0)
    src = rng.random((72, 96), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6


def test_row_shard_parity_downscale_multihop(mesh8):
    # Deep downscale: support exceeds one neighbor band -> multi-hop halo.
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(128, 128, 24, 24, radius_for_tap(4))
    fn, plan = make_sharded_apply(op, mesh8)
    assert not plan.replicate_src
    assert max(plan.hops_up, plan.hops_dn) >= 2  # genuinely multi-hop
    rng = np.random.default_rng(1)
    src = rng.random((128, 128), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 1e-6


def test_row_shard_parity_replicated_fallback(mesh8):
    # Extreme downscale: halos would collect at least the other devices'
    # whole bands -> all_gather fallback (byte break-even, r5).
    from jincresize_tpu.sharding import make_sharded_apply, plan_row_shard

    op = build_plane_operator(256, 256, 8, 8, radius_for_tap(4))
    plan = plan_row_shard(op, 8)
    assert plan.replicate_src
    fn, plan2 = make_sharded_apply(op, mesh8)
    assert plan2.replicate_src
    rng = np.random.default_rng(5)
    src = rng.random((256, 256), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 1e-6


def test_row_shard_parity_deep_multihop(mesh8):
    # 16x downscale on 8 devices: halos span 4 neighbor bands each way but
    # stay under the replication byte break-even -> multi-hop ppermute chain
    # (previously this geometry replicated; parity must hold on the chain).
    from jincresize_tpu.sharding import make_sharded_apply, plan_row_shard

    op = build_plane_operator(256, 256, 16, 16, radius_for_tap(4))
    plan = plan_row_shard(op, 8)
    assert not plan.replicate_src
    assert plan.hops_up >= 2 and plan.hops_dn >= 2
    fn, _ = make_sharded_apply(op, mesh8)
    rng = np.random.default_rng(5)
    src = rng.random((256, 256), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 1e-6


def test_two_device_mesh_reaches_conv_interior():
    # r4 VERDICT missing #2: the hop-count replicate heuristic fired at n=2
    # for EVERY upscale (both halos nonzero), so 2-device meshes — the most
    # common real multi-chip config — could never reach the conv interior.
    # Reference analog: adding a thread never changes the kernel choice
    # (JincResize.cpp:596-598).
    from jincresize_tpu.sharding import ShardedApplier, make_mesh, plan_row_shard

    op = build_plane_operator(96, 72, 192, 144, radius_for_tap(3))
    plan = plan_row_shard(op, 2)
    assert not plan.replicate_src
    ap = ShardedApplier(op, make_mesh(n_rows=2))
    assert ap.interior == "conv-shift"
    rng = np.random.default_rng(11)
    src = rng.random((72, 96), dtype=np.float32)
    out = np.asarray(ap(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 1e-6


def test_data_and_row_shard(mesh_2x4):
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    fn, plan = make_sharded_apply(op, mesh_2x4, data_axis="data")
    rng = np.random.default_rng(2)
    src = rng.random((4, 72, 96), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = np.stack([apply_plane_numpy(op, s) for s in src])
    assert np.abs(out - ref).max() <= 1e-6


def test_uniform_form_matches_dense():
    from jincresize_tpu.golden import materialize_blocks
    from jincresize_tpu.sharding import build_uniform

    op = build_plane_operator(48, 32, 72, 50, radius_for_tap(3))
    blocks_all, bid = build_uniform(op)
    dense = materialize_blocks(op)
    np.testing.assert_array_equal(blocks_all[bid], dense)


def test_sharded_conv_interior_parity(mesh8):
    """Phase-conv sharded path: zero-gather interior + patched borders."""
    from jincresize_tpu.sharding import make_sharded_apply_conv

    op = build_plane_operator(128, 96, 256, 192, radius_for_tap(8))
    r = make_sharded_apply_conv(op, mesh8)
    assert r is not None, "2x tap8 should be eligible for the conv path"
    fn, plan = r
    src = np.random.default_rng(2).random((96, 128), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 1e-6


def test_sharded_conv_matches_gather(mesh8):
    """Cross-impl equivalence between the two sharded interiors (the
    phase-conv shift-sum and the uniform gather form)."""
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(96, 72, 192, 144, radius_for_tap(4))
    fn_c, _ = make_sharded_apply(op, mesh8, impl="conv")
    fn_g, _ = make_sharded_apply(op, mesh8, impl="gather")
    src = np.random.default_rng(3).random((72, 96), dtype=np.float32)
    a = np.asarray(fn_c(src))
    b = np.asarray(fn_g(src))
    assert np.abs(a - b).max() <= 2e-6


def test_sharded_conv_data_axis(mesh_2x4):
    from jincresize_tpu.sharding import make_sharded_apply_conv

    op = build_plane_operator(96, 72, 192, 144, radius_for_tap(3))
    r = make_sharded_apply_conv(op, mesh_2x4, data_axis="data")
    assert r is not None
    fn, _ = r
    src = np.random.default_rng(4).random((2, 72, 96), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = np.stack([apply_plane_numpy(op, s) for s in src])
    assert np.abs(out - ref).max() <= 1e-6


def test_sharded_gather_scan_fallback(mesh8):
    """impl='gather' forces the uniform scan-gather form, here on a tap16
    deep downscale (fs^2 > 1200)."""
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(240, 168, 80, 56, radius_for_tap(16))
    assert op.filter_size**2 > 1200
    fn, _plan = make_sharded_apply(op, mesh8, impl="gather")
    assert fn.info["interior"] == "gather-scan"
    src = np.random.default_rng(12).random((168, 240)).astype(np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_sharded_applier_u8_u16_batched(mesh_2x4):
    """Productized sharded path: in-jit finalize, u8/u16 parity, batched
    frames over the data axis, interior observability (VERDICT r2 item 3)."""
    from jincresize_tpu.sharding import ShardedApplier

    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    ap = ShardedApplier(op, mesh_2x4)
    assert ap.interior in ("conv-shift", "gather-scan")
    rng = np.random.default_rng(5)
    # u8, batch of 3 (not divisible by the data axis of 2 -> pad path).
    src8 = rng.integers(0, 256, (3, 72, 96)).astype(np.uint8)
    out8 = np.asarray(ap(np.asarray(src8), out_dtype=np.uint8, peak=255.0))
    ref8 = np.stack(
        [apply_plane_numpy(op, s, out_dtype=np.uint8, peak=255) for s in src8]
    )
    assert out8.dtype == np.uint8
    assert np.abs(out8.astype(int) - ref8.astype(int)).max() <= 1
    # u16 single frame.
    src16 = rng.integers(0, 65536, (72, 96)).astype(np.uint16)
    out16 = np.asarray(ap(np.asarray(src16), out_dtype=np.uint16, peak=65535.0))
    ref16 = apply_plane_numpy(op, src16, out_dtype=np.uint16, peak=65535)
    assert np.abs(out16.astype(int) - ref16.astype(int)).max() <= 1


def test_sharded_applier_float_clamp(mesh8):
    """float_clamp_min applies inside the sharded jit (SIMD clamp parity)."""
    from jincresize_tpu.sharding import ShardedApplier

    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    ap = ShardedApplier(op, mesh8)
    rng = np.random.default_rng(6)
    src = (rng.random((72, 96), dtype=np.float32) - 0.5) * 2.0
    out = np.asarray(ap(np.asarray(src), float_clamp_min=0.0))
    ref = apply_plane_numpy(op, src, float_clamp_min=0.0)
    assert np.abs(out - ref).max() <= 1e-6


def test_api_impl_sharded(mesh8):
    """impl='sharded' end-to-end through JincResizer on the CPU mesh."""
    from jincresize_tpu.api import JincConfig, JincResizer
    from jincresize_tpu.clip import Clip, random_frame, yuv420p

    clip = Clip.from_frames(
        [random_frame(yuv420p(8), 96, 72, seed=s) for s in (1, 2)]
    )
    cfg = JincConfig(target_width=160, target_height=120, impl="sharded")
    r = JincResizer(clip.format, 96, 72, cfg, frame0=clip.frames[0], mesh=mesh8)
    assert r.engines["luma"].startswith("sharded/")
    out = r(clip)
    ref_cfg = JincConfig(target_width=160, target_height=120, impl="numpy")
    rr = JincResizer(clip.format, 96, 72, ref_cfg, frame0=clip.frames[0])
    ref = rr(clip)
    for i in range(2):
        for n in clip.format.plane_names:
            a = out.frames[i].planes[n].astype(int)
            b = ref.frames[i].planes[n].astype(int)
            assert np.abs(a - b).max() <= 1, (i, n)


def test_row_only_mesh_frame_batch(mesh8):
    """Frame batches on a row-only mesh run ONE vmapped-inside-shard call:
    parity per frame vs the golden, both interiors (the drifted 1.5x
    geometry takes the uniform form under auto)."""
    from jincresize_tpu.sharding import make_sharded_apply

    for op, impl, tol in [
        (build_plane_operator(96, 72, 192, 144, radius_for_tap(3)), "conv", 1e-6),
        (build_plane_operator(320, 180, 480, 270, radius_for_tap(8)), "auto", 2e-5),
        (build_plane_operator(96, 72, 160, 120, radius_for_tap(3)), "gather", 2e-5),
    ]:
        fn, _ = make_sharded_apply(op, mesh8, impl=impl)
        src = np.random.default_rng(6).random(
            (3, op.src_height, op.src_width), dtype=np.float32
        )
        out = np.asarray(fn(src))
        assert out.shape[0] == 3
        for f in range(3):
            ref = apply_plane_numpy(op, src[f])
            assert np.abs(out[f] - ref).max() <= tol, (impl, f)


def test_sharded_conv_deep_tap(mesh8=None):
    """A periodic tap16 2x downscale (fs^2 > 1200) on a mesh rides the
    per-device phase-conv interior (its deep-tap form), not the fs^2-step
    scan-gather. 2-row mesh: the halo is fs-1 = 64 rows on a 270-row
    source."""
    from jincresize_tpu.sharding import ShardedApplier, make_mesh

    op = build_plane_operator(480, 270, 240, 135, radius_for_tap(16))
    assert op.filter_size == 65
    ap = ShardedApplier(op, make_mesh(n_rows=2))
    assert ap.interior == "conv-shift", ap.interior
    src = np.random.default_rng(5).random((270, 480), dtype=np.float32)
    out = np.asarray(ap(src))
    ref = apply_plane_numpy(op, src)
    # 4225 taps/px: the accumulation-order spread vs the row-major golden
    # grows ~sqrt(nnz) past the 1e-6 bound used for fs^2 <= 289 supports
    # (measured 2.6e-6 max here) — same tolerance class as the reference's
    # own C-vs-SIMD paths at this tap count.
    assert np.abs(out - ref).max() <= 4e-6


# Geometry classes of the single-device engine tests, on the 8-device mesh:
# periodic (2x up, 2/3 down, 4x up, sub-pixel crop), drifted (1.5x) and
# aperiodic (96x64 -> 167x113). 'auto' resolves to 'conv-shift' where the
# geometry is periodic and the halos fit, else to the uniform form.
SHARDED_GEOMETRIES = [
    ("2x-up-tap8", (128, 96, 256, 192), 8, {}, "conv-shift"),
    ("2/3-down-tap4", (360, 240, 240, 160), 4, {}, "conv-shift"),
    ("4x-up-tap3", (64, 64, 256, 256), 3, {}, "conv-shift"),
    (
        "subpixel-crop",
        (64, 48, 128, 96),
        4,
        {"crop_left": 0.25, "crop_top": -0.5},
        "conv-shift",
    ),
    ("drifted-1.5x", (320, 180, 480, 270), 8, {}, "gather-scan"),
    ("aperiodic", (96, 64, 167, 113), 3, {}, "gather-scan"),
]


@pytest.mark.parametrize(
    "name,geo,tap,crop,interior",
    SHARDED_GEOMETRIES,
    ids=[g[0] for g in SHARDED_GEOMETRIES],
)
def test_sharded_auto_parity(mesh8, name, geo, tap, crop, interior):
    """Sharded 'auto' picks the expected interior; u8 parity vs the golden."""
    from jincresize_tpu.sharding import ShardedApplier

    sw, sh, dw, dh = geo
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap), **crop)
    ap = ShardedApplier(op, mesh8)
    assert ap.interior == interior
    src = np.random.default_rng(8).integers(0, 256, (sh, sw)).astype(np.uint8)
    out = np.asarray(ap(src, out_dtype=np.uint8, peak=255.0))
    ref = apply_plane_numpy(op, src, out_dtype=np.uint8, peak=255.0)
    assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= 1


@pytest.mark.parametrize(
    "name,geo,tap,crop",
    [g[:4] for g in SHARDED_GEOMETRIES[:4]],
    ids=[g[0] for g in SHARDED_GEOMETRIES[:4]],
)
def test_sharded_uniform_parity_periodic(mesh8, name, geo, tap, crop):
    """The uniform form (impl='gather') on the periodic geometries: float32
    parity vs the golden."""
    from jincresize_tpu.sharding import make_sharded_apply

    sw, sh, dw, dh = geo
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap), **crop)
    fn, _ = make_sharded_apply(op, mesh8, impl="gather")
    assert fn.info["interior"] == "gather-scan"
    src = np.random.default_rng(9).random((sh, sw), dtype=np.float32)
    out = np.asarray(fn(src))
    ref = apply_plane_numpy(op, src)
    assert np.abs(out - ref).max() <= 2e-6


def test_sharded_impl_validation(mesh8):
    """Removed interiors ('seg', 'pallas') are unknown impls."""
    from jincresize_tpu.sharding import make_sharded_apply

    op = build_plane_operator(96, 72, 160, 120, radius_for_tap(3))
    for impl in ("seg", "pallas"):
        with pytest.raises(ValueError, match="unknown impl"):
            make_sharded_apply(op, mesh8, impl=impl)


@pytest.mark.parametrize("impl", ["conv", "gather"])
def test_sharded_tables_not_captured(mesh8, impl):
    """The per-pixel block tables ride as jit arguments: captured as
    constants they were embedded in the executable (3.3 GB at tap16 4K->8K,
    past the 2 GB executable limit)."""
    import warnings

    import jax

    from jincresize_tpu.sharding import make_mesh, make_sharded_apply

    op = build_plane_operator(192, 128, 384, 256, radius_for_tap(16))
    fn, _ = make_sharded_apply(op, make_mesh(n_rows=2), impl=impl)
    before = jax.config.jax_captured_constants_warn_bytes
    jax.config.update("jax_captured_constants_warn_bytes", 1 << 20)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = fn(np.zeros((128, 192), np.float32))
    finally:
        jax.config.update("jax_captured_constants_warn_bytes", before)
    assert out.shape == (256, 384)
