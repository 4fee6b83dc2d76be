"""Double-buffered input streaming: overlap next-batch upload with compute.

A frame pipeline keeps the device busy by uploading batch k+1 while batch k
computes (JAX's async dispatch provides the overlap). This tool measures
that two-slot pipeline against the fully serialized upload->compute->wait
loop on the same workload, and prints both times and the overlap factor:
where host-to-device copies and compute overlap, the pipeline hides
min(upload, compute).

Usage: python tools/streaming_pipeline.py [--frames 16] [--batches 8] [--small]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16, help="frames per batch")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax

    from jincresize_tpu.apply_conv import ConvApplier
    from jincresize_tpu.cache import cached_build
    from jincresize_tpu.compile_cache import enable_compile_cache
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap

    if args.small:
        sw, sh, dw, dh = 960, 540, 1920, 1080
    else:
        sw, sh, dw, dh = 1920, 1080, 3840, 2160
    op = cached_build(
        build_plane_operator,
        src_width=sw,
        src_height=sh,
        dst_width=dw,
        dst_height=dh,
        radius=radius_for_tap(8),
    )
    enable_compile_cache()
    app = ConvApplier(op)
    print(f"# engine: {app.interior}", file=sys.stderr)

    rng = np.random.default_rng(0)
    batches = [
        rng.random((args.frames, sh, sw), dtype=np.float32)
        for _ in range(args.batches)
    ]

    # Warm: compile + first transfer.
    jax.block_until_ready(app(jax.device_put(batches[0])))

    # Serialized: upload -> compute -> wait, one batch at a time.
    t0 = time.time()
    for b in batches:
        jax.block_until_ready(app(jax.device_put(b)))
    t_serial = time.time() - t0

    # Pipelined: two slots; batch k+1 uploads while batch k computes. JAX's
    # async dispatch returns immediately from device_put and from the jitted
    # apply; the only sync point is waiting on the PREVIOUS result.
    t0 = time.time()
    d_cur = jax.device_put(batches[0])
    pending = None
    for k in range(args.batches):
        out = app(d_cur)  # async
        if k + 1 < args.batches:
            d_cur = jax.device_put(batches[k + 1])  # overlaps compute
        if pending is not None:
            jax.block_until_ready(pending)
        pending = out
    jax.block_until_ready(pending)
    t_pipe = time.time() - t0

    px = dw * dh * args.frames * args.batches
    print(
        f"# serialized: {t_serial:.3f}s ({px/t_serial/1e9:.2f} Gpx/s) | "
        f"pipelined: {t_pipe:.3f}s ({px/t_pipe/1e9:.2f} Gpx/s) | "
        f"overlap factor {t_serial/t_pipe:.2f}x",
        file=sys.stderr,
    )
    print(
        '{"metric": "streaming_overlap_factor", "value": %.3f, '
        '"unit": "x", "vs_baseline": %.3f}'
        % (t_serial / t_pipe, t_serial / t_pipe)
    )


if __name__ == "__main__":
    main()
