"""Public API: JincResize filter with the reference's full 16-parameter surface.

Mirrors the script-function layer and construction/validation layer of the
reference (/root/reference/src/JincResize.cpp:654-984 ``Create_JincResize``,
:986-1111 registration and fixed-tap aliases): same parameter names, defaults,
ranges and error messages; the four alias entry points ``jinc36_resize`` /
``jinc64_resize`` / ``jinc144_resize`` / ``jinc256_resize`` pin ``tap`` to
3/4/6/8 exactly like ``Jinc36/64/144/256Resize``.

Differences from the reference (by design, SURVEY.md §7):
  * construction builds device-resident sparse operators instead of pointer
    tables; ``threads``/``opt``/``initial_capacity``/``initial_factor`` are
    validated with reference semantics but execution is selected via ``impl``
    ('auto' | 'conv' | 'xla' | 'sharded' | 'numpy') since XLA owns codegen
    (C17).
  * frame processing is a pure jitted function; batches of frames map to the
    SpMM path.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from . import apply_xla
from .clip import Clip, Frame, VideoFormat
from .filters import build_lut
from .geometry import chroma_crop
from .golden import apply_plane_numpy, finalize as finalize_np
from .operator import PlaneOperator, build_plane_operator, radius_for_tap


class JincError(ValueError):
    """Construction-time validation error (reference: avs_new_value_error)."""


@dataclass(frozen=True)
class JincConfig:
    """All JincResize parameters with reference defaults (README.md:33-111)."""

    target_width: int
    target_height: int
    src_left: float = 0.0
    src_top: float = 0.0
    src_width: float | None = None  # <=0: crop from the right
    src_height: float | None = None  # <=0: crop from the bottom
    quant_x: int = 256
    quant_y: int = 256
    tap: int = 3
    blur: float = 0.0  # 0 means unset -> 1.0 (JincResize.cpp:772-774)
    cplace: str | None = None  # None: resolve from frame props, else mpeg2
    threads: int = 0
    opt: int = -1
    initial_capacity: int | None = None
    initial_factor: float = 1.5
    # Execution selector (replaces the ISA dispatch, SURVEY C17): 'auto'
    # takes the engine phase.select_engine picks from the geometry — the
    # phase-conv shift-sum for periodic geometry, else the XLA gather path;
    # 'conv' forces the phase-conv engine (error if ineligible); 'xla' the
    # gather path; 'sharded' the multi-device path; 'numpy' is the host
    # golden.
    impl: str = "auto"  # 'auto'|'conv'|'xla'|'sharded'|'numpy'
    # Float-path source clamp: the reference's SIMD kernels clamp float
    # sources at -0.5 (chroma/alpha) / 0.0 (luma/RGB) while the C kernel does
    # not. None reproduces the reference dispatch: clamp unless opt == 0.
    float_clamp: bool | None = None
    # Interior precision: 'fp32' (parity). 'bf16' is accepted for API
    # compatibility; every engine runs full float32 math, so it executes as
    # 'fp32' (ConvApplier.effective_precision).
    precision: str = "fp32"
    # Geometry position semantics: 'f32' replicates the reference's serial
    # float32 position walk bit-for-bit (parity default). 'f64' is the
    # drift-free mode — positions evaluated directly in float64, so rational
    # scale ratios stay exactly periodic and ride the conv path instead
    # of the per-pixel-weight gather path (e.g. a 1.5x upscale: the f32
    # drift fragments it into ~60 quasi-periodic segments; f64 runs it as a
    # clean p=3 phase conv). Documented non-parity mode: output differs from
    # the reference wherever drift flipped a quantization class.
    pos_precision: str = "f32"
    # Disk-cache built operators keyed by geometry (cache.py): repeat
    # constructions of the same geometry skip the host build entirely
    # (SURVEY.md §5 checkpoint/resume — the coefficient table is the only
    # durable state). Cache dir: $JINCRESIZE_CACHE_DIR.
    operator_cache: bool = True


def _resolve_cplace(cfg: JincConfig, fmt: VideoFormat, frame0: Frame | None) -> str:
    cplace = cfg.cplace
    if cplace:
        cplace = cplace.lower()
        if cplace not in ("mpeg2", "mpeg1", "topleft"):
            raise JincError("JincResize: cplace must be MPEG2, MPEG1 or topleft.")
    else:
        # Frame-prop fallback (JincResize.cpp:727-742).
        loc = None if frame0 is None else frame0.props.get("_ChromaLocation")
        if loc is None:
            cplace = "mpeg2"
        elif loc == 0:
            cplace = "mpeg2"
        elif loc == 1:
            cplace = "mpeg1"
        elif loc == 2:
            cplace = "topleft"
        else:
            raise JincError("JincResize: invalid _ChromaLocation")
    if cplace == "topleft" and not fmt.is_420:
        raise JincError(
            "JincResize: topleft must be used only for 4:2:0 chroma subsampling."
        )
    return cplace


def _validate(cfg: JincConfig) -> None:
    """Reference argument validation with identical messages
    (JincResize.cpp:703-789)."""
    if not 1 <= cfg.tap <= 16:
        raise JincError("JincResize: tap must be between 1..16.")
    if not 1 <= cfg.quant_x <= 256:
        raise JincError("JincResize: quant_x must be between 1..256.")
    if not 1 <= cfg.quant_y <= 256:
        raise JincError("JincResize: quant_y must be between 1..256.")
    if cfg.opt > 3:
        raise JincError("JincResize: opt higher than 3 is not allowed.")
    if cfg.threads not in (0, 1):
        raise JincError("JincResize: threads must be either 0 or 1.")
    if cfg.initial_factor < 1.0:
        raise JincError(
            "JincResize: initial_factor must be eqaul to or greater than 1.0."
        )
    if cfg.initial_capacity is not None and cfg.initial_capacity <= 0:
        raise JincError("JincResize: initial_capacity must be greater than 0.")
    if cfg.impl not in ("auto", "conv", "xla", "numpy", "sharded"):
        raise JincError(f"JincResize: unknown impl {cfg.impl!r}.")
    if cfg.precision not in ("fp32", "bf16"):
        raise JincError(f"JincResize: unknown precision {cfg.precision!r}.")
    if cfg.pos_precision not in ("f32", "f64"):
        raise JincError(
            f"JincResize: unknown pos_precision {cfg.pos_precision!r}."
        )


def _select_engine(op: PlaneOperator, impl: str, precision: str):
    """Pick the execution engine for one plane operator.

    Returns (applier_or_None, engine_name); engine_name is 'shift'
    (ConvApplier) or 'xla' (no applier — the general XLA path). The choice
    comes from the geometry alone (phase.select_engine). ``impl='conv'``
    runs the conv engine or raises, mirroring the reference's honest 48-way
    dispatch (JincResize.cpp:897-972) where ``opt`` selects the kernel that
    executes.
    """
    from .apply_conv import ConvApplier
    from .phase import select_engine

    engine, plan = select_engine(op)
    if engine == "conv":
        app = ConvApplier(op, plan=plan, precision=precision)
        return app, app.interior
    if impl == "conv":
        raise JincError(
            "JincResize: impl='conv' requires periodic geometry "
            "(use impl='auto' for automatic fallback)."
        )
    return None, "xla"


class JincResizer:
    """Constructed filter instance: operators built once, frames are pure calls.

    Equivalent of the reference's filter object: construction = validation +
    LUT + per-geometry coefficient tables (JincResize.cpp:791-866); per-frame
    call = table application only (JincResize.cpp:603-630).
    """

    def __init__(
        self,
        fmt: VideoFormat,
        width: int,
        height: int,
        cfg: JincConfig,
        frame0: Frame | None = None,
        mesh=None,
    ):
        _validate(cfg)
        if mesh is not None and cfg.impl not in ("auto", "sharded"):
            raise JincError(
                "JincResize: mesh is only valid with impl='sharded' or 'auto'."
            )
        self.fmt = fmt
        self.src_width = width
        self.src_height = height
        self.cfg = cfg
        self.cplace = _resolve_cplace(cfg, fmt, frame0)

        # Crop semantics including negative src_width/height = right/bottom
        # crop (JincResize.cpp:762-770).
        crop_left = cfg.src_left
        crop_width = float(width) if cfg.src_width is None else float(cfg.src_width)
        if crop_width <= 0.0:
            crop_width = width - crop_left + crop_width
        crop_top = cfg.src_top
        crop_height = float(height) if cfg.src_height is None else float(cfg.src_height)
        if crop_height <= 0.0:
            crop_height = height - crop_top + crop_height

        blur = cfg.blur if cfg.blur else 1.0
        tw, th = cfg.target_width, cfg.target_height
        radius = radius_for_tap(cfg.tap)
        lut = build_lut(radius, blur)
        self.peak = fmt.peak

        if cfg.operator_cache:
            # Warm constructions load the serialized operator instead of
            # re-running the host build (cache.py; keyed by geometry +
            # builder version). The LUT is derived from (radius, blur),
            # which are both in the key.
            from .cache import cached_build

            def _build(**geometry):
                return cached_build(
                    lambda **g: build_plane_operator(lut=lut, **g), **geometry
                )

        else:

            def _build(**geometry):
                return build_plane_operator(lut=lut, **geometry)

        # Luma/444/RGB operator (out[0] — also used for alpha planes).
        self.op_luma: PlaneOperator = _build(
            src_width=width,
            src_height=height,
            dst_width=tw,
            dst_height=th,
            radius=radius,
            crop_left=crop_left,
            crop_top=crop_top,
            crop_width=crop_width,
            crop_height=crop_height,
            quantize_x=cfg.quant_x,
            quantize_y=cfg.quant_y,
            blur=blur,
            # None for the parity default keeps pre-existing cache keys valid
            # (cached_build drops None-valued kwargs from the key).
            pos_precision=None if cfg.pos_precision == "f32" else cfg.pos_precision,
        )
        # Subsampled chroma operator (out[1]) with chroma-siting shift
        # (JincResize.cpp:830-862).
        self.op_chroma: PlaneOperator | None = None
        if fmt.family == "YUV" and fmt.is_subsampled:
            cl, ct, cw, ch = chroma_crop(
                self.cplace,
                width,
                height,
                tw,
                th,
                crop_left,
                crop_top,
                crop_width,
                crop_height,
                fmt.sub_w,
                fmt.sub_h,
            )
            self.op_chroma = _build(
                src_width=width >> fmt.sub_w,
                src_height=height >> fmt.sub_h,
                dst_width=tw >> fmt.sub_w,
                dst_height=th >> fmt.sub_h,
                radius=radius,
                crop_left=cl,
                crop_top=ct,
                crop_width=cw,
                crop_height=ch,
                quantize_x=cfg.quant_x,
                quantize_y=cfg.quant_y,
                blur=blur,
                pos_precision=(
                    None if cfg.pos_precision == "f32" else cfg.pos_precision
                ),
            )

        # Luma geometry kwargs, kept for the drift hint (below).
        self._luma_geometry = dict(
            src_width=width,
            src_height=height,
            dst_width=tw,
            dst_height=th,
            radius=radius,
            crop_left=crop_left,
            crop_top=crop_top,
            crop_width=crop_width,
            crop_height=crop_height,
            quantize_x=cfg.quant_x,
            quantize_y=cfg.quant_y,
        )
        self._init_engines(mesh)

        # Float-source clamp per plane (SIMD semantics unless opt==0).
        clamp = cfg.float_clamp
        if clamp is None:
            clamp = cfg.opt != 0
        self._float_clamp = clamp and fmt.bits == 32

    # --------------------------------------------------------------- engines
    def _init_engines(self, mesh=None) -> None:
        """Select and build the execution engine per plane operator.

        Populates ``self.engines`` — the per-plane executed engine
        (observability: the reference's `opt` genuinely selects the kernel
        that runs, JincResize.cpp:897-972; tests assert these match the
        requested impl).
        """
        cfg, fmt = self.cfg, self.fmt
        self._impl = cfg.impl
        self._dev_luma = None
        self._dev_chroma = None
        self._applier_luma = None
        self._applier_chroma = None
        self.engines: dict[str, str] = {}
        if self._impl == "sharded" or (self._impl == "auto" and mesh is not None):
            # Multi-chip path: row-sharded apply over a device mesh with
            # in-jit finalize (SURVEY.md §2 parallelism table; the reference
            # has no distributed mode). Default mesh: all visible devices on
            # the row axis.
            from .sharding import ShardedApplier, make_mesh

            if mesh is None:
                mesh = make_mesh()
            self._applier_luma = ShardedApplier(self.op_luma, mesh)
            self.engines["luma"] = f"sharded/{self._applier_luma.interior}"
            if self.op_chroma is not None:
                self._applier_chroma = ShardedApplier(self.op_chroma, mesh)
                self.engines["chroma"] = f"sharded/{self._applier_chroma.interior}"
            self._impl = "sharded"
            return
        if self._impl in ("auto", "conv", "xla"):
            self._dev_luma = apply_xla.to_device(self.op_luma)
            if self.op_chroma is not None:
                self._dev_chroma = apply_xla.to_device(self.op_chroma)
        if self._impl in ("auto", "conv"):
            self._applier_luma, eng = _select_engine(
                self.op_luma, self._impl, cfg.precision
            )
            self.engines["luma"] = eng
            if self.op_chroma is not None:
                self._applier_chroma, eng = _select_engine(
                    self.op_chroma, self._impl, cfg.precision
                )
                self.engines["chroma"] = eng
        else:  # 'xla' | 'numpy'
            self.engines["luma"] = self._impl
            if self.op_chroma is not None:
                self.engines["chroma"] = self._impl
        self._maybe_drift_hint()

    def _maybe_drift_hint(self) -> None:
        """Log when pos_precision='f64' would lift this request onto the conv
        path (drift fragmented an otherwise-periodic rational geometry)."""
        cfg = self.cfg
        geo = getattr(self, "_luma_geometry", None)
        if (
            geo is None
            or cfg.impl != "auto"
            or cfg.pos_precision != "f32"
            or self.engines.get("luma") != "xla"
        ):
            return
        try:
            from .geometry import build_plane_geometry
            from .phase import geometry_is_periodic

            # dists=False: the probe needs only classes/starts/borders —
            # skip the (dst x fs) distance matrices the full build computes.
            g = build_plane_geometry(pos_dtype="f64", dists=False, **geo)
            if geometry_is_periodic(g):
                from .metrics import logger

                logger.info(
                    "geometry is quasi-periodic: float32 position drift forced "
                    "the %s path; pos_precision='f64' (documented non-parity "
                    "mode) would run this request on the phase-conv engine.",
                    self.engines["luma"],
                )
        except Exception:  # the hint must never break construction
            from .metrics import logger

            logger.debug("drift hint probe failed", exc_info=True)

    # ------------------------------------------------------------------ plane
    def _plane_op(self, name: str):
        """Coefficient-table select per plane: chroma planes use out[1] for
        subsampled formats, everything else (incl. alpha) uses out[0]
        (resize_plane kernels' table select, e.g. resize_plane_avx2.cpp:26-32)."""
        if name in ("U", "V") and self.op_chroma is not None:
            return self.op_chroma, self._dev_chroma, self._applier_chroma
        return self.op_luma, self._dev_luma, self._applier_luma

    def _clamp_min(self, name: str) -> float | None:
        if not self._float_clamp:
            return None
        # (i && !is_rgb) -> -0.5 else 0.0 (resize_plane_avx2.cpp:24).
        if self.fmt.family != "RGB" and name != self.fmt.plane_names[0]:
            return -0.5
        return 0.0

    # ------------------------------------------------------------------ frame
    def _store_peak(self) -> float:
        """Integer store clamp. SIMD store semantics under the reference's
        default dispatch (opt != 0): u16 stores saturate at the TYPE max via
        packus (resize_plane_avx2.cpp:89 _mm_packus_epi32), not at `peak` —
        9..15-bit overshoot may exceed peak exactly as it does in the
        reference's SIMD paths; only opt=0 selects the C kernel's peak clamp
        (JincResize.cpp:581-584). u8 (packus chain saturates at 255 == peak)
        and 16-bit (65535 == peak) are unaffected. Applied to every engine
        including the numpy path, which — like the float clamp — models
        whichever reference kernel the configured ``opt`` would dispatch to
        ON A SIMD-CAPABLE HOST (the reference's opt=-1 would fall back to the
        C kernel's peak clamp only on a host without SSE4.1; that host class
        is not modeled here)."""
        if self.cfg.opt != 0 and 8 < self.fmt.bits < 16:
            return 65535.0
        return self.peak

    def _device_resize(self, name: str, src):
        """Resample a device batch (F, h, w) of one plane on the selected
        device engine; returns the device array without waiting for it."""
        op, dop, cop = self._plane_op(name)
        kw = dict(
            out_dtype=self.fmt.dtype,
            peak=self._store_peak(),
            float_clamp_min=self._clamp_min(name),
        )
        if cop is not None:
            return cop(src, **kw)
        return apply_xla.resize_plane_batch(dop, src, **kw)

    def _resize_planes(self, name: str, src: np.ndarray) -> np.ndarray:
        """Resample a batch (F, h, w) of one plane through the selected impl."""
        if self._impl == "numpy":
            op = self._plane_op(name)[0]
            return np.stack(
                [
                    apply_plane_numpy(
                        op,
                        s,
                        out_dtype=self.fmt.dtype,
                        peak=self._store_peak(),
                        float_clamp_min=self._clamp_min(name),
                    )
                    for s in src
                ]
            )
        import jax.numpy as jnp

        return np.asarray(self._device_resize(name, jnp.asarray(src)))

    def _out_frame(self, planes: dict, props: dict) -> Frame:
        out = Frame(format=self.fmt, planes=planes, props=dict(props))
        # _ChromaLocation output prop for 420/422/411 (JincResize.cpp:617-625).
        if self.fmt.is_420 or self.fmt.is_422 or self.fmt.is_411:
            loc = {"mpeg2": 0, "mpeg1": 1, "topleft": 2}[self.cplace]
            out = out.with_props(_ChromaLocation=loc)
        return out

    def process_frame(self, frame: Frame) -> Frame:
        """Resample one frame (all planes). Pure; no state mutated."""
        frame.validate()
        out_planes = {
            name: self._resize_planes(name, np.asarray(frame.planes[name])[None])[0]
            for name in self.fmt.plane_names
        }
        return self._out_frame(out_planes, frame.props)

    def process_clip_batched(self, clip: Clip) -> Clip:
        """Resample all frames in one batched (SpMM) dispatch per plane.

        The reference reaches frame parallelism through the host running N
        filter instances (MT_MULTI_INSTANCE, JincResize.cpp:649-652); here
        frames batch as the dense RHS of the sparse
        operator (SURVEY.md §2 parallelism table) — one device dispatch per
        plane instead of one per frame-plane.
        """
        for f in clip.frames:
            f.validate()
        out_by_plane = {
            name: self._resize_planes(
                name, np.stack([f.planes[name] for f in clip.frames], axis=0)
            )
            for name in self.fmt.plane_names
        }
        frames = tuple(
            self._out_frame(
                {n: out_by_plane[n][i] for n in self.fmt.plane_names}, f.props
            )
            for i, f in enumerate(clip.frames)
        )
        return Clip(
            format=self.fmt,
            frames=frames,
            width=self.cfg.target_width,
            height=self.cfg.target_height,
        )

    def __call__(self, clip: Clip) -> Clip:
        if len(clip.frames) > 1 and self._impl != "numpy":
            return self.process_clip_batched(clip)
        frames = tuple(self.process_frame(f) for f in clip.frames)
        return Clip(
            format=self.fmt,
            frames=frames,
            width=self.cfg.target_width,
            height=self.cfg.target_height,
        )


def jinc_resize(
    clip: Clip,
    target_width: int,
    target_height: int,
    mesh=None,
    **kwargs,
) -> Clip:
    """``JincResize(clip, target_width, target_height, ...)`` — full 16-param
    surface (JincResize.cpp:1044-1060). ``mesh`` (a jax.sharding.Mesh with a
    'rows' axis) routes execution through the multi-chip sharded path."""
    cfg = JincConfig(target_width=target_width, target_height=target_height, **kwargs)
    frame0 = clip.frames[0] if len(clip.frames) else None
    resizer = JincResizer(
        clip.format, clip.width, clip.height, cfg, frame0=frame0, mesh=mesh
    )
    return resizer(clip)


class ChainResizer(JincResizer):
    """Composed multi-stage resizer: one fused operator for a whole chain.

    New capability relative to the reference (compose.py): chained script
    calls there resample twice with intermediate rounding; here the per-stage
    operators are pre-composed by SpGEMM into ONE banded operator per plane,
    so frame time is a single pass with no intermediate quantization loss,
    and the composed operator re-enters every execution engine (conv / XLA
    gather / sharded) through the normal selector.
    """

    def __init__(
        self,
        fmt: VideoFormat,
        width: int,
        height: int,
        cfgs: list[JincConfig],
        frame0: Frame | None = None,
        mesh=None,
    ):
        if not cfgs:
            raise JincError("JincResize: chain needs at least one stage.")
        from .compose import compose

        # Resolve cplace once from the first stage (later stages would read
        # the _ChromaLocation prop the previous stage wrote — same value).
        cpl = _resolve_cplace(cfgs[0], fmt, frame0)
        for cfg in cfgs:
            _validate(cfg)
        last = cfgs[-1]

        # Composed-operator cache: keyed by the full stage chain + plane
        # (extends cache.py's single-geometry keys to chains, ROADMAP 13).
        cache_paths = {}
        if all(c.operator_cache for c in cfgs):
            from dataclasses import asdict

            from .cache import default_cache_dir, geometry_key

            def _desc(c: JincConfig) -> dict:
                d = asdict(c)
                # Drop everything that does not affect coefficients.
                for k in (
                    "impl",
                    "precision",
                    "operator_cache",
                    "threads",
                    "opt",
                    "initial_capacity",
                    "initial_factor",
                    "float_clamp",
                    "cplace",
                ):
                    d.pop(k, None)
                # Parity default stays out of the key so pre-existing chain
                # cache entries remain valid (mirrors cached_build's
                # None-dropping for single geometries).
                if d.get("pos_precision") == "f32":
                    d.pop("pos_precision")
                return d

            base = dict(
                chain=[_desc(c) for c in cfgs],
                cplace=cpl,
                src=[width, height],
                sub=[fmt.sub_w, fmt.sub_h],
                family=fmt.family,
            )
            for plane in ("luma", "chroma"):
                key = geometry_key(plane=plane, **base)
                cache_paths[plane] = default_cache_dir() / f"chain_{key}.npz"

        def _load(plane):
            from .cache import load_operator

            p = cache_paths.get(plane)
            if p is not None and p.exists():
                try:
                    return load_operator(p)
                except Exception:
                    return None
            return None

        need_chroma = fmt.family == "YUV" and fmt.is_subsampled
        composed_luma = _load("luma")
        composed_chroma = _load("chroma") if need_chroma else None
        self.stages = []
        if composed_luma is None or (need_chroma and composed_chroma is None):
            # Stage resizers are built engine-less (impl='numpy') — only
            # their operators are consumed. cplace pinned to the resolved
            # value so subsampled chroma siting matches chained execution.
            stages = []
            w, h = width, height
            for cfg in cfgs:
                r = JincResizer(
                    fmt, w, h, replace(cfg, impl="numpy", cplace=cpl), frame0=None
                )
                stages.append(r)
                w, h = cfg.target_width, cfg.target_height
            self.stages = stages
            from .cache import save_operator

            if composed_luma is None:
                composed_luma = stages[0].op_luma
                for r in stages[1:]:
                    composed_luma = compose(composed_luma, r.op_luma)
                if cache_paths:
                    try:
                        save_operator(composed_luma, cache_paths["luma"])
                    except OSError:
                        pass
            if need_chroma and composed_chroma is None:
                composed_chroma = stages[0].op_chroma
                for r in stages[1:]:
                    composed_chroma = compose(composed_chroma, r.op_chroma)
                if cache_paths:
                    try:
                        save_operator(composed_chroma, cache_paths["chroma"])
                    except OSError:
                        pass

        # Adopt the final stage's identity, then install the composed
        # operators and select engines exactly like a single-stage resizer.
        self.fmt = fmt
        self.src_width = width
        self.src_height = height
        self.cfg = last
        self.cplace = cpl
        self.peak = fmt.peak
        self.op_luma = composed_luma
        self.op_chroma = composed_chroma
        self._init_engines(mesh)
        clamp = last.float_clamp
        if clamp is None:
            clamp = last.opt != 0
        self._float_clamp = clamp and fmt.bits == 32


def jinc_resize_chain(clip: Clip, stages: list[dict], mesh=None) -> Clip:
    """Run a chain of resizes as ONE composed operator pass.

    ``stages`` is a list of jinc_resize keyword dicts (each needs
    ``target_width``/``target_height``). Equivalent to nested jinc_resize
    calls for float clips, minus the intermediate passes; for integer clips
    it SKIPS the intermediate round/clamp (a quality improvement — documented
    deviation from running the stages separately).
    """
    cfgs = [JincConfig(**s) for s in stages]
    frame0 = clip.frames[0] if len(clip.frames) else None
    r = ChainResizer(
        clip.format, clip.width, clip.height, cfgs, frame0=frame0, mesh=mesh
    )
    return r(clip)


def _alias(tap: int):
    """Fixed-tap alias: forwards the reduced parameter set and pins tap
    (resizer_jincresize<taps>, JincResize.cpp:1031-1040)."""

    def fn(
        clip: Clip,
        target_width: int,
        target_height: int,
        src_left: float = 0.0,
        src_top: float = 0.0,
        src_width: float | None = None,
        src_height: float | None = None,
        quant_x: int = 256,
        quant_y: int = 256,
        cplace: str | None = None,
        threads: int = 0,
        **extra,
    ) -> Clip:
        return jinc_resize(
            clip,
            target_width,
            target_height,
            src_left=src_left,
            src_top=src_top,
            src_width=src_width,
            src_height=src_height,
            quant_x=quant_x,
            quant_y=quant_y,
            cplace=cplace,
            threads=threads,
            tap=tap,
            **extra,
        )

    fn.__name__ = f"jinc{tap * tap * 4}_resize"
    return fn


jinc36_resize = _alias(3)
jinc64_resize = _alias(4)
jinc144_resize = _alias(6)
jinc256_resize = _alias(8)
