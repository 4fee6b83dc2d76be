"""End-to-end smoke of the resize path on NVIDIA GPUs (H100).

    python chip_smoke.py          # one GPU: card-only tests, device check,
                                  # full-width cases, geometry sweep
    python chip_smoke.py --multi  # four GPUs: the row-sharded path only

One GPU. The ``gpu``-marked pytest tests run first, in a child process that
must be the only JAX process on the card, so this process touches JAX only
after it. Then the device check, the served path at real widths (cases
A-D through ``jinc_resize`` with the default ``impl='auto'``) and a
geometry sweep at small sizes. Every output is compared with the host golden
(``impl='numpy'``, golden.py): at most 1 LSB for u8/u16 and 2e-6 absolute
for fp32. Times are informational, printed beside the card's name and power
limit.

``--multi`` runs only the sharded path: tap 16 4K->8K fp32 on a 4-row mesh
and a 2x2 ('data', 'rows') mesh, compared with the one-card output of the
same clip and with the golden on a fixed set of rows.

Exits non-zero if any phase fails, and prints no result when JAX finds no
GPU. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from jincresize_tpu.api import JincConfig, JincResizer, jinc_resize  # noqa: E402
from jincresize_tpu.clip import Clip, gray, random_frame, yuv420p, yuv444p  # noqa: E402
from jincresize_tpu.compile_cache import enable_compile_cache  # noqa: E402
from jincresize_tpu.golden import apply_plane_numpy  # noqa: E402
from jincresize_tpu.metrics import gpu_cards  # noqa: E402
from jincresize_tpu.phase import plan_phases  # noqa: E402

F32_TOL = 2e-6  # absolute, fp32 planes
INT_TOL = 1  # LSB, u8/u16 planes
# Full-frame golden only where it stays near a minute on the host:
# dst pixels x taps per frame; above it, a fixed set of rows.
FULL_GOLDEN_MAX_MACS = 6e8


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> list[str]:
    """``name, power.limit`` per card; raises when there is no NVIDIA GPU."""
    cards = gpu_cards()
    if not cards:
        raise SmokeError("nvidia-smi lists no GPU")
    return cards


def device_phase(min_count: int = 1) -> dict:
    """Phase 1: JAX must see the GPU; never carry on on the CPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeError(f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    if len(devs) < min_count:
        raise SmokeError(f"{len(devs)} GPU(s) visible, need {min_count}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    log(f"device: {info['kind']} x{info['count']} ({info['platform']})")
    for line in nvidia_smi():
        log(line)
    log(f"compile cache: {enable_compile_cache()}")
    return info


def max_dev(out: np.ndarray, ref: np.ndarray) -> float:
    if out.dtype == np.float32:
        return float(np.abs(out - ref).max())
    return int(np.abs(out.astype(np.int64) - ref.astype(np.int64)).max())


def within_tol(out: np.ndarray, d) -> bool:
    return d <= (F32_TOL if out.dtype == np.float32 else INT_TOL)


def golden_rows(op, extra=()) -> np.ndarray:
    """Every border-strip row, every exception row, 8 interior rows, and
    ``extra`` (e.g. the rows either side of a device boundary)."""
    rows = set(range(op.y_lo)) | set(range(op.y_hi, op.dst_height))
    plan = plan_phases(op)
    if plan is not None:
        rows |= {int(r) for r in plan.y.exceptions}
    rows |= {int(r) for r in np.linspace(op.y_lo, op.y_hi - 1, 8)}
    rows |= {int(r) for r in extra}
    return np.array(sorted(r for r in rows if 0 <= r < op.dst_height))


def golden_refs(resizer: JincResizer, clip: Clip, extra_rows=()) -> list:
    """Host-golden values of every plane of every frame: the full plane on
    frame 0 where it is cheap, the fixed rows elsewhere."""
    fmt, refs = resizer.fmt, []
    for name in fmt.plane_names:
        op = resizer._plane_op(name)[0]
        full = op.dst_width * op.dst_height * op.filter_size**2 <= FULL_GOLDEN_MAX_MACS
        rows = golden_rows(op, extra_rows)
        for i, f in enumerate(clip.frames):
            sel = None if (full and i == 0) else rows
            ref = apply_plane_numpy(
                op,
                np.asarray(f.planes[name]),
                out_dtype=fmt.dtype,
                peak=resizer._store_peak(),
                float_clamp_min=resizer._clamp_min(name),
                rows=sel,
            )
            refs.append((name, i, sel, ref))
    return refs


def golden_check(out: Clip, refs: list) -> str:
    """Compare ``out`` with golden_refs; raises on a deviation past the
    bound, returns a one-line summary."""
    worst, how = {}, set()
    for name, i, sel, ref in refs:
        got = out.frames[i].planes[name]
        got = got if sel is None else got[sel]
        how.add("full frame 0" if sel is None else f"{len(sel)} rows")
        d = max_dev(got, ref)
        worst[name] = max(worst.get(name, 0), d)
        if not within_tol(got, d):
            raise SmokeError(f"plane {name} frame {i}: max deviation {d}")
    return f"max dev {worst} vs golden ({', '.join(sorted(how))})"


def _clip(fmt, w, h, frames, seed=0) -> Clip:
    return Clip.from_frames(
        [random_frame(fmt, w, h, seed=seed + i) for i in range(frames)]
    )


def _median_ms(fn, iters: int = 5) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def served_case(name, fmt, src, dst, tap, frames, **kw) -> None:
    """Phase 2 case: build, first call, steady-state times, golden parity."""
    import jax

    (sw, sh), (dw, dh) = src, dst
    clip = _clip(fmt, sw, sh, frames)
    cfg = JincConfig(target_width=dw, target_height=dh, tap=tap, **kw)
    t0 = time.perf_counter()
    r = JincResizer(fmt, sw, sh, cfg, frame0=clip.frames[0])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r(clip)
    first_s = time.perf_counter() - t0
    host_ms = _median_ms(lambda: r(clip)) / frames
    dev_src = {
        n: jax.device_put(np.stack([f.planes[n] for f in clip.frames]))
        for n in fmt.plane_names
    }
    dev_ms = (
        _median_ms(
            lambda: jax.block_until_ready(
                [r._device_resize(n, dev_src[n]) for n in fmt.plane_names]
            )
        )
        / frames
    )
    out = jinc_resize(clip, dw, dh, tap=tap, **kw)
    summary = golden_check(out, golden_refs(r, clip))
    log(
        f"  {name}: engines {r.engines}; build {build_s:.1f} s, first call "
        f"{first_s:.1f} s; device {dev_ms:.3f} ms/frame, host call "
        f"{host_ms:.3f} ms/frame (median of 5, {frames} frames); {summary}"
    )


SERVED = [
    # (name, format, src, dst, tap, frames, kwargs)
    ("A jinc256 4K->8K fp32", gray(32), (3840, 2160), (7680, 4320), 8, 4, {}),
    (
        "B tap3 1080p->4K yuv420p10 mpeg2",
        yuv420p(10),
        (1920, 1080),
        (3840, 2160),
        3,
        8,
        {"cplace": "mpeg2"},
    ),
    ("C tap8 1080p->1620p yuv420p8", yuv420p(8), (1920, 1080), (2880, 1620), 8, 4, {}),
    ("D tap16 4K->1080p fp32", gray(32), (3840, 2160), (1920, 1080), 16, 4, {}),
]

# Geometry sweep at small sizes: (name, sw, sh, dw, dh, tap, bits, kwargs).
# "fmt": "420" selects yuv420p.
SWEEP = [
    ("2x upscale qx=1", 96, 64, 192, 128, 8, 8, {}),
    ("2x downscale qx=2", 192, 128, 96, 64, 3, 8, {}),
    ("3/2 upscale px=3 qx=2", 128, 96, 192, 144, 4, 16, {}),
    ("4x upscale px=4", 64, 48, 256, 192, 3, 32, {}),
    ("2/3 downscale px=2 qx=3", 192, 144, 128, 96, 3, 8, {}),
    ("2x subpixel crop", 96, 64, 192, 128, 4, 8, {"src_left": 1.25, "src_top": 0.5}),
    ("blur + quant1", 96, 64, 144, 96, 3, 16, {"blur": 0.98, "quant_x": 1, "quant_y": 1}),
    ("tap16 2x upscale", 96, 64, 192, 128, 16, 32, {}),
    ("420 topleft chroma", 128, 96, 256, 192, 3, 8, {"cplace": "topleft", "fmt": "420"}),
    ("f64 3/2 subpixel crop", 128, 96, 192, 144, 4, 8,
     {"src_left": 0.123, "src_top": 0.456, "pos_precision": "f64"}),
    # Wide-phase plans: anisotropic px=8 / py=4, and 5/2 (py*px=25) with
    # exception rows and columns.
    ("f64 8/3-by-4/3 px=8", 360, 240, 960, 320, 4, 8,
     {"src_left": 0.3, "src_top": 0.3, "pos_precision": "f64"}),
    ("5/2 upscale p=5 exceptions", 160, 120, 400, 300, 3, 32, {}),
    # Drifted rational scales under parity positions: the XLA path.
    ("1.5x drifted parity", 640, 360, 960, 540, 8, 8, {}),
    ("2.5x exceptions", 1920, 80, 4800, 200, 2, 8, {}),
    # Deep-tap plans (fs^2 > SHIFT_UNROLL_MAX): the scan-form interior.
    ("tap16 0.5x deep", 480, 270, 240, 135, 16, 32, {}),
    ("tap16 2/3 deep p2", 480, 270, 320, 180, 16, 32, {}),
]


def sweep_case(name, sw, sh, dw, dh, tap, bits, kw) -> None:
    kw = dict(kw)
    fmt = yuv420p(bits) if kw.pop("fmt", None) == "420" else yuv444p(bits)
    clip = _clip(fmt, sw, sh, 1, seed=7)
    r = JincResizer(fmt, sw, sh, JincConfig(dw, dh, tap=tap, **kw), frame0=clip.frames[0])
    out = r(clip)
    ref = jinc_resize(clip, dw, dh, tap=tap, impl="numpy", **kw).frames[0]
    d = max(max_dev(out.frames[0].planes[n], ref.planes[n]) for n in ref.planes)
    ok = within_tol(out.frames[0].planes["Y"], d)
    log(f"  {name:28s} {'ok' if ok else 'PARITY FAIL'}  maxdiff={d}  engines={r.engines}")
    if not ok:
        raise SmokeError(f"sweep case {name!r}: max deviation {d}")


def card_tests_phase() -> None:
    """Phase 4: the gpu-marked tests, in a child that is the only JAX
    process on the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [sys.executable, "-m", "pytest", "-q", "-rs", "-m", "gpu",
           "-p", "no:cacheprovider", "tests"]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
    log(r.stdout.strip())
    if r.returncode != 0:
        log(r.stderr.strip()[-4000:])
        raise SmokeError(f"card-only tests exited {r.returncode}")
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if not re.search(r"\d+ passed", tail) or re.search(r"skipped|failed|error", tail):
        raise SmokeError(f"card-only tests did not all run and pass: {tail!r}")


def multi_phase(src=(3840, 2160), dst=(7680, 4320), tap=16, frames=4) -> None:
    """Phase 5 (--multi): the row-sharded path over 4 devices, on a 4-row
    mesh and a 2x2 ('data', 'rows') mesh, against the one-card output of
    the same clip and the golden on fixed rows."""
    import jax

    from jincresize_tpu.sharding import make_mesh

    (sw, sh), (dw, dh) = src, dst
    fmt = gray(32)
    clip = _clip(fmt, sw, sh, frames, seed=11)
    cfg = JincConfig(target_width=dw, target_height=dh, tap=tap)
    t0 = time.perf_counter()
    single = jinc_resize(clip, dw, dh, tap=tap)
    log(f"  one card: {time.perf_counter() - t0:.1f} s incl. build + compile")
    refs = None
    for label, mesh in (
        ("rows=4", make_mesh(n_rows=4)),
        ("data=2 x rows=2", make_mesh(n_rows=2, n_data=2)),
    ):
        t0 = time.perf_counter()
        r = JincResizer(fmt, sw, sh, cfg, frame0=clip.frames[0], mesh=mesh)
        build_s = time.perf_counter() - t0
        app = r._applier_luma
        t0 = time.perf_counter()
        out = r(clip)
        first_s = time.perf_counter() - t0
        dev_src = jax.device_put(np.stack([f.planes["Y"] for f in clip.frames]))
        y = jax.block_until_ready(r._device_resize("Y", dev_src))
        n_dev = len(y.sharding.device_set)
        if n_dev != 4:
            raise SmokeError(f"{label}: output spans {n_dev} devices, not 4")
        dev_ms = (
            _median_ms(lambda: jax.block_until_ready(r._device_resize("Y", dev_src)))
            / frames
        )
        d1 = max(
            max_dev(out.frames[i].planes["Y"], single.frames[i].planes["Y"])
            for i in range(frames)
        )
        if not within_tol(out.frames[0].planes["Y"], d1):
            raise SmokeError(f"{label}: max deviation {d1} from the one-card output")
        if refs is None:
            # The 4-row mesh's device boundaries include the 2-row mesh's.
            td = app.plan.dst_rows_per
            bounds = [b + o for b in range(td, dh, td) for o in (-1, 0)]
            refs = golden_refs(r, clip, extra_rows=bounds)
            log(f"  one card: {golden_check(single, refs)}")
        summary = golden_check(out, refs)
        log(
            f"  {label}: interior {app.interior}, engines {r.engines}, output "
            f"on {n_dev} devices; build {build_s:.1f} s, first call "
            f"{first_s:.1f} s; device {dev_ms:.3f} ms/frame (median of 5, "
            f"{frames} frames); max dev {d1} vs one card; {summary}"
        )


def run_phase(name: str, fn, failures: list) -> None:
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        fn()
    except Exception:  # report, go on with the next phase, fail at the end
        traceback.print_exc()
        failures.append(name)
        log(f"== {name}: FAILED")
        return
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--multi", action="store_true", help="four GPUs: run only the sharded phase"
    )
    args = ap.parse_args(argv)
    try:
        nvidia_smi()
    except (OSError, subprocess.SubprocessError, SmokeError) as e:
        print(f"chip_smoke: no NVIDIA GPU: {e}", file=sys.stderr)
        return 1

    failures: list[str] = []
    if not args.multi:
        run_phase("card-only tests (gpu marker, child process)", card_tests_phase, failures)
    try:
        info = device_phase(min_count=4 if args.multi else 1)
    except SmokeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.multi:
        run_phase("sharded path, 4 devices", multi_phase, failures)
    else:
        for case in SERVED:
            run_phase(f"served: {case[0]}", lambda c=case: served_case(*c[:6], **c[6]), failures)
        for case in SWEEP:
            run_phase(f"sweep: {case[0]}", lambda c=case: sweep_case(*c), failures)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
