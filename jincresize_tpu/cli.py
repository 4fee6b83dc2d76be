"""Command-line interface: resample planar frames/clips stored as .npy/.npz.

The reference's "CLI" is the AviSynth script-function registration
(JincResize.cpp:1042-1111); this rebuild exposes the same parameter
surface as a standalone command, plus the rebuild-only capabilities
(engine selection, multi-device meshes, composed chains):

    python -m jincresize_tpu INPUT OUTPUT --width W --height H [--tap N] ...

INPUT formats:
  * .npy — a single 2-D array (GRAY plane), 3-D (planes, H, W) RGB stack
    when the leading dim is 3, or 3-D (F, H, W) GRAY clip with --clip;
  * .npz — named planes (Y/U/V/A or G/B/R/A) with optional `_props` JSON.
    Each plane may be 2-D (one frame) or 3-D (F, h, w) — a multi-frame
    clip, processed in ONE batched (SpMM) dispatch per plane.

Output mirrors the input container (clips stay stacked along dim 0).

Chains: `--chain '[{"target_width": 960, "target_height": 540}, {...}]'`
runs the stages as ONE SpGEMM-composed operator pass (api.jinc_resize_chain);
the final stage inherits the top-level --tap/--quant/... unless overridden
per stage. --width/--height then describe the LAST stage and may be omitted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _infer_bits(arr) -> int:
    return 32 if arr.dtype == np.float32 else (8 if arr.dtype == np.uint8 else 16)


def _load(path: str, clip_3d: bool):
    """Load INPUT -> (Clip, is_clip_container) of 1+ frames."""
    from .clip import Clip, Frame, VideoFormat

    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        names = [n for n in ("Y", "U", "V", "A", "G", "B", "R") if n in z.files]
        if not names:
            raise SystemExit(f"{path}: no plane arrays (Y/U/V/A or G/B/R/A)")
        planes = {n: z[n] for n in names}
        props = {}
        if "_props" in z.files:
            props = json.loads(str(z["_props"]))
        if "G" in planes:
            family, sub_w, sub_h = "RGB", 0, 0
        elif "U" in planes:
            family = "YUV"
            ly, lx = planes["Y"].shape[-2:]
            cy, cx = planes["U"].shape[-2:]
            sub_w = (lx // cx).bit_length() - 1
            sub_h = (ly // cy).bit_length() - 1
        else:
            family, sub_w, sub_h = "GRAY", 0, 0
        arr = next(iter(planes.values()))
        fmt = VideoFormat(family, sub_w, sub_h, _infer_bits(arr), has_alpha="A" in planes)
        if arr.ndim == 3:  # (F, h, w) clip planes
            nf = arr.shape[0]
            frames = [
                Frame(format=fmt, planes={n: planes[n][i] for n in names}, props=props)
                for i in range(nf)
            ]
            return Clip.from_frames(frames), True
        return Clip.from_frames([Frame(format=fmt, planes=planes, props=props)]), False
    arr = np.load(path)
    bits = _infer_bits(arr)
    if arr.ndim == 2:
        fmt = VideoFormat("GRAY", 0, 0, bits)
        return Clip.from_frames([Frame(format=fmt, planes={"Y": arr})]), False
    if arr.ndim == 3 and clip_3d:
        fmt = VideoFormat("GRAY", 0, 0, bits)
        return (
            Clip.from_frames(
                [Frame(format=fmt, planes={"Y": arr[i]}) for i in range(arr.shape[0])]
            ),
            True,
        )
    if arr.ndim == 3 and arr.shape[0] == 3:
        fmt = VideoFormat("RGB", 0, 0, bits)
        return (
            Clip.from_frames(
                [Frame(format=fmt, planes={"G": arr[0], "B": arr[1], "R": arr[2]})]
            ),
            False,
        )
    raise SystemExit(f"unsupported input array shape {arr.shape} (use --clip for F,H,W)")


def _save(path: str, clip, is_clip: bool) -> None:
    frame0 = clip.frames[0]
    names = frame0.format.plane_names
    if path.endswith(".npz"):
        if is_clip:
            arrays = {
                n: np.stack([f.planes[n] for f in clip.frames]) for n in names
            }
        else:
            arrays = dict(frame0.planes)
        arrays["_props"] = np.array(json.dumps(frame0.props))
        np.savez(path, **arrays)
        return
    if is_clip:
        np.save(path, np.stack([f.planes[names[0]] for f in clip.frames]))
    elif len(names) == 1:
        np.save(path, frame0.planes[names[0]])
    else:
        np.save(path, np.stack([frame0.planes[n] for n in names[:3]]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="jincresize_tpu", description=__doc__.split("\n")[0]
    )
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--src-left", type=float, default=0.0)
    ap.add_argument("--src-top", type=float, default=0.0)
    ap.add_argument("--src-width", type=float, default=None)
    ap.add_argument("--src-height", type=float, default=None)
    ap.add_argument("--quant-x", type=int, default=256)
    ap.add_argument("--quant-y", type=int, default=256)
    ap.add_argument("--tap", type=int, default=3)
    ap.add_argument("--blur", type=float, default=0.0)
    ap.add_argument("--cplace", default=None)
    ap.add_argument(
        "--impl",
        default="auto",
        choices=["auto", "conv", "xla", "sharded", "numpy"],
        help="execution engine (honest dispatch: the named engine runs or errors)",
    )
    ap.add_argument(
        "--precision",
        default="fp32",
        choices=["fp32", "bf16"],
        help="interior precision; bf16 is accepted and runs as fp32",
    )
    ap.add_argument(
        "--pos-precision",
        default="f32",
        choices=["f32", "f64"],
        help="position semantics: f32 = reference-parity drifting walk; "
        "f64 = drift-free geometry (rational ratios stay on the conv path)",
    )
    ap.add_argument(
        "--float-clamp",
        default="auto",
        choices=["auto", "on", "off"],
        help="float-source clamp (-0.5 chroma / 0.0 luma); auto = reference SIMD semantics",
    )
    ap.add_argument(
        "--clip",
        action="store_true",
        help="treat a 3-D .npy input as (F, H, W) GRAY frames instead of RGB planes",
    )
    ap.add_argument(
        "--chain",
        default=None,
        help="JSON list of stage dicts; runs all stages as ONE composed operator pass",
    )
    ap.add_argument(
        "--mesh",
        type=int,
        default=None,
        metavar="N",
        help="shard rows over an N-device mesh (implies the multi-chip path)",
    )
    ap.add_argument("--no-cache", action="store_true", help="disable the operator disk cache")
    ap.add_argument("--time", action="store_true", help="print build/apply wall times")
    args = ap.parse_args(argv)

    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    from .api import JincConfig, JincError, jinc_resize_chain, JincResizer

    clip, is_clip = _load(args.input, args.clip)
    for f in clip.frames:
        f.validate()

    common = dict(
        src_left=args.src_left,
        src_top=args.src_top,
        src_width=args.src_width,
        src_height=args.src_height,
        quant_x=args.quant_x,
        quant_y=args.quant_y,
        tap=args.tap,
        blur=args.blur,
        cplace=args.cplace,
        impl=args.impl,
        precision=args.precision,
        pos_precision=args.pos_precision,
        operator_cache=not args.no_cache,
    )
    if args.float_clamp != "auto":
        common["float_clamp"] = args.float_clamp == "on"

    mesh = None
    if args.mesh is not None:
        from .sharding import make_mesh

        mesh = make_mesh(args.mesh)

    t0 = time.time()
    try:
        if args.chain is not None:
            stages = json.loads(args.chain)
            if not isinstance(stages, list) or not stages:
                raise SystemExit("--chain must be a non-empty JSON list of stage dicts")
            # Stages inherit the top-level parameters unless overridden.
            stages = [dict(common, **s) for s in stages]
            if args.width is not None:
                stages[-1].setdefault("target_width", args.width)
                stages[-1].setdefault("target_height", args.height)
            for i, s in enumerate(stages):
                if "target_width" not in s or "target_height" not in s:
                    raise SystemExit(f"--chain stage {i}: target_width/target_height required")
            out = jinc_resize_chain(clip, stages, mesh=mesh)
            engines = "chain"
        else:
            if args.width is None or args.height is None:
                raise SystemExit("--width/--height are required (unless --chain sets them)")
            cfg = JincConfig(target_width=args.width, target_height=args.height, **common)
            resizer = JincResizer(
                clip.format,
                clip.width,
                clip.height,
                cfg,
                frame0=clip.frames[0],
                mesh=mesh,
            )
            t_built = time.time()
            out = resizer(clip)
            engines = ",".join(f"{k}={v}" for k, v in resizer.engines.items())
            if args.time:
                print(f"# build {t_built-t0:.2f}s apply {time.time()-t_built:.2f}s",
                      file=sys.stderr)
    except JincError as e:
        print(str(e), file=sys.stderr)
        return 2
    _save(args.output, out, is_clip)
    f0, o0 = clip.frames[0], out.frames[0]
    print(
        f"{f0.width}x{f0.height} -> {o0.width}x{o0.height} x{len(out.frames)} "
        f"({f0.format.family}, {f0.format.bits}-bit, tap={args.tap}, "
        f"engines: {engines})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
