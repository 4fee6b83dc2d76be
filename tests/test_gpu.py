"""Card-only parity checks (``gpu`` marker): skipped on the CPU harness, run
on an NVIDIA GPU by chip_smoke.py's card-only phase.

Each compiles a parity-path program for the card and compares it with the
host golden at the float32 bound. A contraction left to run in TF32, or a
GPU-specific lowering that reorders a long sum, shows up here.
"""

import numpy as np
import pytest

from jincresize_tpu.golden import apply_plane_numpy
from jincresize_tpu.operator import build_plane_operator, radius_for_tap

pytestmark = pytest.mark.gpu


def _f32_src(op, seed=0):
    return np.random.default_rng(seed).random(
        (op.src_height, op.src_width), dtype=np.float32
    )


@pytest.mark.parametrize(
    "geo,tap",
    [
        ((960, 540, 1920, 1080), 8),  # 2x headline shape, strips
        ((160, 120, 400, 300), 3),  # exception rows/columns (fixup einsums)
        ((480, 270, 240, 135), 16),  # deep-tap scan form
    ],
    ids=["2x-tap8", "5/2-exceptions", "tap16-deep"],
)
def test_gpu_conv_engine_parity(geo, tap):
    import jax
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier

    assert jax.default_backend() == "gpu"
    op = build_plane_operator(*geo, radius_for_tap(tap))
    src = _f32_src(op)
    out = np.asarray(ConvApplier(op)(jnp.asarray(src)))
    assert float(np.abs(out - apply_plane_numpy(op, src)).max()) <= 2e-6


@pytest.mark.parametrize(
    "geo,tap",
    [((640, 360, 960, 540), 8), ((96, 64, 167, 113), 3)],
    ids=["drifted-1.5x", "aperiodic"],
)
def test_gpu_xla_path_parity(geo, tap):
    """The XLA gather path's contractions (class-contraction and general
    branches) at HIGHEST."""
    import jax.numpy as jnp

    from jincresize_tpu import apply_xla

    op = build_plane_operator(*geo, radius_for_tap(tap))
    src = _f32_src(op, 1)
    out = np.asarray(apply_xla.resize_plane(apply_xla.to_device(op), jnp.asarray(src)))
    assert float(np.abs(out - apply_plane_numpy(op, src)).max()) <= 2e-6

