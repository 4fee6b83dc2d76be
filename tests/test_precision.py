"""Every contraction on the parity path names its precision.

On the GPU a float32 dot_general at DEFAULT precision may run in TF32 and
break parity with the host golden. These tests lower the parity-path jits
and check that every dot_general carries HIGHEST (or an explicit dot
algorithm), so no site is left to the backend's default.
"""

import pytest

from jincresize_tpu.operator import build_plane_operator, radius_for_tap


def _dot_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if "dot_general" in ln]


def _assert_explicit(text: str, min_dots: int) -> None:
    dots = _dot_lines(text)
    assert len(dots) >= min_dots, f"expected >= {min_dots} dot_general, got {len(dots)}"
    for ln in dots:
        highest = "precision = [HIGHEST, HIGHEST]" in ln
        assert highest or "algorithm" in ln, ln


def _conv(geo, tap):
    import jax.numpy as jnp

    from jincresize_tpu.apply_conv import ConvApplier

    op = build_plane_operator(*geo, radius_for_tap(tap))
    ap = ConvApplier(op)
    src = jnp.zeros((op.src_height, op.src_width), jnp.float32)
    return ap._jit.lower(ap.cop, src).as_text()


def _xla(geo, tap):
    import jax.numpy as jnp

    from jincresize_tpu import apply_xla

    op = build_plane_operator(*geo, radius_for_tap(tap))
    dop = apply_xla.to_device(op)
    src = jnp.zeros((2, op.src_height, op.src_width), jnp.float32)
    return apply_xla.resize_plane_batch.lower(dop, src).as_text()


def _sharded(geo, tap, impl):
    import jax
    import jax.numpy as jnp

    from jincresize_tpu.sharding import make_mesh, make_sharded_apply

    op = build_plane_operator(*geo, radius_for_tap(tap))
    fn, _ = make_sharded_apply(op, make_mesh(n_rows=2), impl=impl)
    src = jnp.zeros((op.src_height, op.src_width), jnp.float32)
    return jax.jit(lambda s: fn(s)).lower(src).as_text()


CASES = [
    # (id, lowering, args, minimum dot_general count)
    ("conv-exception-fixups", _conv, ((160, 120, 400, 300), 3), 1),
    ("conv-headline-2x", _conv, ((128, 96, 256, 192), 8), 0),
    ("conv-deep-tap16", _conv, ((480, 270, 240, 135), 16), 0),
    ("xla-class-contraction", _xla, ((64, 48, 128, 96), 3), 1),
    ("xla-general", _xla, ((96, 64, 167, 113), 3), 1),
    ("sharded-conv", _sharded, ((128, 96, 256, 192), 8, "conv"), 0),
    ("sharded-uniform", _sharded, ((96, 72, 160, 120), 3, "gather"), 0),
]


@pytest.mark.parametrize(
    "name,lower,args,min_dots", CASES, ids=[c[0] for c in CASES]
)
def test_parity_path_dots_are_highest(name, lower, args, min_dots):
    _assert_explicit(lower(*args), min_dots)


def test_checker_flags_default_precision():
    """The checker itself rejects a dot_general left at DEFAULT."""
    import jax
    import jax.numpy as jnp

    a = jnp.zeros((8, 8), jnp.float32)
    text = jax.jit(lambda x: x @ x).lower(a).as_text()
    with pytest.raises(AssertionError):
        _assert_explicit(text, 1)
    text = jax.jit(
        lambda x: jnp.matmul(x, x, precision=jax.lax.Precision.HIGHEST)
    ).lower(a).as_text()
    _assert_explicit(text, 1)
