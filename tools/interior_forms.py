"""Time the phase-conv interior's XLA forms on the device, at real widths.

    python tools/interior_forms.py [--frames 4] [--iters 5] [--small]

Each form computes the same (nphase, nyb, nxb) interior from the same
source windows and weights, vmapped over a frame batch:

  shift          unrolled shift-sum (apply_conv.phase_interior's default)
  scan           _shift_sum_scan: tap rows in a lax.scan, golden tap order
  conv           lax.conv_general_dilated at HIGHEST (cuDNN on the GPU)

Geometries: Jinc256 tap 8 4K->8K (the headline, fs^2 = 289) and tap 16
4K->1080p (the deep-tap regime, fs^2 = 4225, where the unrolled form is not
compiled). For each form it prints the median ms/frame over ``--iters``
calls synchronised with block_until_ready, the compile time, and the
largest deviation from the reference form (shift for the headline, scan for
the deep taps — both keep the golden's tap order). A form that fails to
compile or run is reported and skipped. The card's name and power limit
are printed first; times are comparable only within one run.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--small", action="store_true", help="1/16 of the pixels")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from jincresize_tpu import apply_conv as ac
    from jincresize_tpu.cache import cached_build
    from jincresize_tpu.compile_cache import enable_compile_cache
    from jincresize_tpu.metrics import gpu_cards
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap

    enable_compile_cache()
    try:
        card = "; ".join(gpu_cards())
    except (OSError, subprocess.SubprocessError) as e:
        card = f"not read ({e})"
    d = jax.devices()[0]
    print(f"# device {d.platform} {d.device_kind}; card: {card}", flush=True)

    HIGHEST = jax.lax.Precision.HIGHEST
    div = 4 if args.small else 1
    geos = [
        ("tap8 4K->8K", (3840, 2160, 7680, 4320), 8),
        ("tap16 4K->1080p", (3840, 2160, 1920, 1080), 16),
    ]
    for label, (sw, sh, dw, dh), tap in geos:
        sw, sh, dw, dh = sw // div, sh // div, dw // div, dh // div
        op = cached_build(
            build_plane_operator,
            src_width=sw,
            src_height=sh,
            dst_width=dw,
            dst_height=dh,
            radius=radius_for_tap(tap),
        )
        cop = ac.build_conv_operator(op)
        (ylo, xlo, py, px, qy, qx, by, bx, nyb, nxb, Kh, Kw) = cop.meta
        K = cop.kernels[:, 0]
        fs = op.filter_size
        deep = Kh * Kw > ac.SHIFT_UNROLL_MAX
        src = jnp.asarray(
            np.random.default_rng(0).random((args.frames, sh, sw), dtype=np.float32)
        )
        lhs = jax.jit(jax.vmap(lambda s: ac.conv_window(cop, s)))(src)
        macs = nyb * nxb * py * px * fs * fs
        print(
            f"## {label}: fs={fs} p=({py},{px}) q=({qy},{qx}) K=({Kh},{Kw}) "
            f"{macs / 1e9:.2f} GMAC/frame, {args.frames} frames",
            flush=True,
        )

        def conv_form(x):
            y = jax.lax.conv_general_dilated(
                x[None, None],
                K[:, None],
                window_strides=(qy, qx),
                padding="VALID",
                precision=HIGHEST,
            )
            return y[0, :, :nyb, :nxb]

        forms = {}
        if not deep:
            forms["shift"] = lambda x: ac.phase_interior(
                x, K, cop.phase_offsets, qy, qx, nyb, nxb, fs
            )
        forms["scan"] = lambda x: ac._shift_sum_scan(x, K, qy, qx, nyb, nxb)
        forms["conv"] = conv_form

        ref = None
        for name, form in forms.items():
            fn = jax.jit(jax.vmap(form))
            try:
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(lhs))
                compile_s = time.perf_counter() - t0
                times = []
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(lhs))
                    times.append(time.perf_counter() - t0)
            except Exception as e:  # report the form, go on with the next
                print(f"  {name:14s} FAILED: {str(e).splitlines()[0][:200]}", flush=True)
                continue
            ms = statistics.median(times) * 1e3 / args.frames
            if ref is None:
                ref = np.asarray(out)
                dev = 0.0
            else:
                dev = float(np.abs(np.asarray(out) - ref).max())
            print(
                f"  {name:14s} {ms:9.3f} ms/frame  compile+first {compile_s:6.1f} s"
                f"  max dev vs {list(forms)[0]} {dev:.3g}"
                f"  {macs / (ms * 1e-3) / 1e12:.2f} TMAC/s",
                flush=True,
            )


if __name__ == "__main__":
    main()
