"""Benchmark: Jinc256 (tap=8) 4K->8K fp32 Y-plane throughput on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Diagnostics, including the GPU's name and power limit, go to stderr.

Baseline derivation (the reference publishes no numbers — BASELINE.md §1):
the per-socket-equivalent bar is the analytic peak of the reference's AVX-512
path on a strong 32-core AVX-512 socket: 18.05 GMAC padded per 4K->8K tap-8
fp32 frame (BASELINE.md §2), 32 cores x 16 lanes x 2 FMA x 3 GHz = 1.54 TMAC/s
peak => 85.3 fps => 2.83e9 output px/s. Real sockets fall short of peak on
this memory-bound gather; using peak makes the bar conservative (harder).

Usage: python bench.py [--small] [--frames N] [--iters N] [--impl auto|conv|xla]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Analytic AVX-512 per-socket-equivalent bar (see module docstring).
BASELINE_PX_PER_S = 7680 * 4320 * (1.54e12 / 18.05e9)


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _print_card() -> None:
    """The card's name and power limit: a capped card runs slower."""
    from jincresize_tpu.metrics import gpu_cards

    try:
        card = "; ".join(gpu_cards())
    except (OSError, subprocess.SubprocessError) as e:
        card = f"not read ({e})"
    print(f"# card: {card}", file=sys.stderr)


def _median_s(fn, x, iters: int) -> float:
    """Median wall time of ``fn(x)`` after one warm-up call, each call
    synchronised with block_until_ready."""
    import jax

    jax.block_until_ready(fn(x))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def scaling_main(args):
    """nnz/s scaling over the visible devices (BASELINE.md §3: ">=90% nnz/s
    scaling at 2+ hosts"), measured at n_rows 1/2/4/8 up to the device count.

    Prints per-configuration nnz/s to stderr and ONE JSON line:
    {"metric": "nnz_scaling_<k>dev", "value": <k-dev efficiency>, ...} where
    efficiency = (nnz/s at k devices) / (k x nnz/s at 1 device).
    """
    import jax
    import jax.numpy as jnp

    from jincresize_tpu.api import _select_engine
    from jincresize_tpu import apply_xla
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap
    from jincresize_tpu.sharding import ShardedApplier, make_mesh

    sw, sh, dw, dh = 480, 272, 960, 544
    op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(3))
    nnz = op.stats()["logical_nnz"]
    F = max(2, min(args.frames, 4))
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.random((F, sh, sw), dtype=np.float32))

    # Baseline (k=1): the SINGLE-device engine, not a 1-device mesh — a
    # 1-device "mesh" degenerates to the replicate fallback and would make
    # the scaling denominator an artifact. Efficiency thus reads "per-device
    # rate retained when row-sharding across k devices vs one unsharded one".
    rates, engines, per_k = {}, {}, []
    for k in (1, 2, 4, 8):
        if k > len(jax.devices()):
            break
        if k == 1:
            ap, engines[1] = _select_engine(op, "auto", "fp32")
            if ap is None:
                dop = apply_xla.to_device(op)
                ap = lambda x: apply_xla.resize_plane_batch(dop, x)
        else:
            ap = ShardedApplier(op, make_mesh(n_rows=k))
            engines[k] = ap.interior
        dt = _median_s(ap, src, 3)
        rates[k] = nnz * F / dt
        per_k.append(
            {"k": k, "ms_batch": dt * 1e3, "gnnz_s": rates[k] / 1e9, "interior": engines[k]}
        )
        print(
            f"# n_rows={k}: {dt*1e3:.3f} ms/batch ({F} frames), "
            f"{rates[k]/1e9:.3f} Gnnz/s, interior={engines[k]}",
            file=sys.stderr,
        )
    kmax = max(rates)
    eff = rates[kmax] / (kmax * rates[1])
    print(
        json.dumps(
            {
                "metric": f"nnz_scaling_{kmax}dev",
                "value": eff,
                "unit": "fraction_of_linear",
                "vs_baseline": eff / 0.9,
                "per_k": per_k,
                "device": _device_info(),
            }
        )
    )
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="reduced size (CI/dev)")
    # Frames are batched per dispatch (vmap SpMM — BASELINE.json config #4's
    # frame batching).
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument(
        "--downscale",
        action="store_true",
        help="bench the 4K->1080p downscale (qx>1, inflated support)",
    )
    ap.add_argument(
        "--tap16-downscale",
        action="store_true",
        help="tap16 4K->1080p (fs=65, fs^2=4225): the deep-tap interior form "
        "(p=1, q=2 plan)",
    )
    ap.add_argument("--impl", default="auto", choices=["auto", "conv", "xla"])
    ap.add_argument(
        "--scaling",
        action="store_true",
        help="nnz/s scaling harness (BASELINE.md §3): run the row-sharded "
        "apply at n_rows in {1,2,4,8} up to the visible device count and "
        "report per-config nnz/s + scaling efficiency",
    )
    ap.add_argument(
        "--precision",
        default="fp32",
        choices=["fp32", "bf16"],
        help="accepted for API compatibility; every engine runs fp32",
    )
    args = ap.parse_args()

    from jincresize_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    _print_card()
    if args.scaling:
        return scaling_main(args)

    import jax.numpy as jnp

    from jincresize_tpu import apply_xla
    from jincresize_tpu.operator import build_plane_operator, radius_for_tap

    tap = 8
    if args.tap16_downscale or args.downscale:
        tap = 16 if args.tap16_downscale else 8
        if args.small:
            sw, sh, dw, dh = 1920, 1080, 960, 540
        else:
            sw, sh, dw, dh = 3840, 2160, 1920, 1080
    elif args.small:
        sw, sh, dw, dh = 960, 540, 1920, 1080
    else:
        sw, sh, dw, dh = 3840, 2160, 7680, 4320

    t0 = time.time()
    from jincresize_tpu.cache import cached_build

    op = cached_build(
        build_plane_operator,
        src_width=sw,
        src_height=sh,
        dst_width=dw,
        dst_height=dh,
        radius=radius_for_tap(tap),
    )
    build_s = time.time() - t0
    print(f"# operator built in {build_s:.1f}s: {op.stats()}", file=sys.stderr)

    impl = args.impl
    if impl == "auto":
        from jincresize_tpu.phase import select_engine

        impl = select_engine(op)[0]
    if impl == "conv":
        from jincresize_tpu.apply_conv import ConvApplier

        fn = ConvApplier(op, precision=args.precision)
        print(f"# interior engine: {fn.interior}", file=sys.stderr)
    else:
        dop = apply_xla.to_device(op)
        fn = (
            (lambda s: apply_xla.resize_plane_batch(dop, s))
            if args.frames > 1
            else (lambda s: apply_xla.resize_plane(dop, s))
        )
    rng = np.random.default_rng(0)
    shape = (args.frames, sh, sw) if args.frames > 1 else (sh, sw)
    src = jnp.asarray(rng.random(shape, dtype=np.float32))

    dt = _median_s(fn, src, args.iters)
    frames = max(args.frames, 1)
    px_per_s = dw * dh * frames / dt
    print(
        f"# impl={impl} {dt*1e3:.3f} ms/batch for {frames} frame(s) "
        f"({dw}x{dh}), {px_per_s/1e9:.3f} Gpx/s",
        file=sys.stderr,
    )

    # nnz/s traceability (BASELINE.md §3): logical weights applied per second.
    nnz_per_px = op.stats()["logical_nnz"] / (dw * dh)
    print(
        f"# logical nnz/s: {px_per_s * nnz_per_px / 1e12:.3f} T "
        f"({nnz_per_px:.0f} nnz/px)",
        file=sys.stderr,
    )

    if args.downscale or args.tap16_downscale:
        # Per-socket-equivalent bar at THIS geometry's padded MAC cost
        # (the reference's per-px work inflates with the support; same
        # 1.54 TMAC/s analytic socket as BASELINE_PX_PER_S).
        fs = op.filter_size
        stride = (fs + 15) & ~15
        base = 1.54e12 / (fs * stride)
        kind = "tap16" if args.tap16_downscale else "jinc256"
        metric = (
            f"{kind}_4k_to_1080p_fp32_px_per_s_per_chip"
            if not args.small
            else f"{kind}_1080p_to_540p_fp32_px_per_s_per_chip"
        )
        vs = px_per_s / base
    else:
        scale = 1.0 if not args.small else 0.25  # report vs the 8K bar regardless
        metric = (
            "jinc256_4k_to_8k_fp32_px_per_s_per_chip"
            if not args.small
            else "jinc256_1080p_fp32_px_per_s_per_chip"
        )
        vs = px_per_s / (BASELINE_PX_PER_S * scale)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": px_per_s,
                "unit": "px/s",
                "vs_baseline": vs,
                "device": _device_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
