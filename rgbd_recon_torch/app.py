"""kinect_client equivalent on the card (mirrors ``rgbd_recon_tpu/app.py``).

    python -m rgbd_recon_torch.app <scene.ks> [run.conf] [options]

The reference binary (source/kinect_client.cpp:864-1015 ``main``, :580-614
frame loop) is a GLFW/ImGui viewer; this client is headless: the frame
loop reconstructs with ``FramePipeline`` and reports through FPS lines,
per-stage timer CSVs and PNG frame/texture dumps instead of a window. The
control surface is the JAX app's:

* CLI options ``-s -d -w -l -r -m -c -f -p`` (kinect_client.cpp:868-930),
  the headless extensions (``-recordings -outdir -dump-every
  -dump-textures -frames -serve -draw-frustums -draw-bricks``) and
  ``-device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
  PyTorch versions) — the counterpart of the JAX app's ``JAX_PLATFORMS``;
* ``.conf`` keys (kinect_client.cpp:292-315) and the positional
  ``<scene.ks>`` [``<run.conf>``];
* sources: ``.stream`` replay from ``recordings/<yml-base>.stream`` or
  live ZMQ SUB (``-p``); compressed payloads decode on the device
  (``ops/wire.py``) when ``RGBD_WIRE_DECODE`` is ``1``, or ``auto`` (the
  default) on a CUDA device;
* with a conf loaded: quit after ``time_limit`` seconds and write
  ``{mean,min,max}_<conf-base>,<Y-m-d>,<H-M>.csv`` (:831-847,1003-1012);
* the runtime control channel (``-serve``'s ``POST /control``) through
  ``FramePipeline.retune`` and config rebuilds.

Recon mode 1 (integration) runs ``FramePipeline``; modes 0/2/3 (points,
trigrid, mvt) draw with the strategies of ``models/`` from the frames of
``FramePipeline.preprocess`` (the session bakes and the sensor filtering
alone), and a control command or a stereo feedback message switches among
modes 0-3 mid-run. ``-draw-bricks`` overlays the occupied bricks (brick
marking on the frame, kernel 4 on the card) in modes other than
integration, as in the reference. ``bricking: false`` (in the ``.conf`` or
as a control command) runs the pipeline's reference path at the res
derived at align 1; a bricking toggle logs the res it derives. The JAX app's
``_enable_compile_cache`` (XLA's persistent compile cache) has no
counterpart: the CUDA kernels are built once per source hash by
``native.build``.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .calibration.files import load_scene
from .io.cmdparser import CMDParser
from .io.configurator import Configurator
from .io.ingest import DeviceFeed, FeedbackReceiver, ZMQIngest
from .io.stream import StreamReader
from .io.viewer import LiveViewer
from .models import ReconCalibs, ReconContext, ReconMVT, ReconPoints, ReconTrigrid
from .ops import bricks as brick_ops
from .ops.raymarch import RenderCamera
from .ops.wire import make_wire_decoder
from .runtime.pipeline import FramePipeline, PipelineConfig
from .utils import overlay
from .utils.math import perspective
from .utils.navigator import CameraNavigator
from .utils.png import write_png
from .utils.stereo import StereoCamera, anaglyph_composite, side_by_side_composite
from .utils.timers import TimerDatabase


@dataclass
class AppConfig:
    """Config-file-driven state (defaults = kinect_client.cpp:70-92)."""

    recon_mode: int = 1
    screen_width: int = 1280
    screen_height: int = 720
    # stereo state (kinect_client.cpp:55-66 defaults)
    stereo_mode: int = 0          # 0 mono, 1 anaglyph, 2 side-by-side
    screen_width_real: float = 1.28   # physical screen metres (-s)
    screen_height_real: float = 0.72
    window_width: int = 1280      # side-by-side window (-w)
    window_height: int = 720
    left_pos: tuple = (0, 0)      # viewport origins, GL bottom-left (-l/-r)
    right_pos: tuple = (0, 0)
    clear_color: tuple = (0.0, 0.0, 0.0, 0.0)   # -c
    # mono-mode debug overlays (kinect_client.cpp:672-708 GUI toggles;
    # draw_grid is also a .conf key)
    draw_frustums: bool = False
    draw_bricks: bool = False
    play: bool = True
    draw_grid: bool = False
    animate: bool = False
    bilateral: bool = True
    processed: bool = True
    refine: bool = True
    colorfill: bool = True
    bricking: bool = True
    skip_space: bool = True
    watch_errors: bool = True
    voxel_size: float = 0.01
    brick_size: float = 0.1
    tsdf_limit: float = 0.01
    zoom: float = 2.5
    time_limit: int = 0
    loaded_conf: bool = False
    conf_file: str = ""


def load_config(cfg: AppConfig, file_name: str) -> None:
    """load_config (kinect_client.cpp:292-315)."""
    c = Configurator.instance()
    c.read(file_name)
    c.print()
    cfg.recon_mode = c.get_uint("recon_mode", cfg.recon_mode)
    cfg.screen_width = c.get_uint("screenWidth", cfg.screen_width)
    cfg.screen_height = c.get_uint("screenHeight", cfg.screen_height)
    cfg.play = c.get_bool("play", cfg.play)
    cfg.draw_grid = c.get_bool("draw_grid", cfg.draw_grid)
    cfg.animate = c.get_bool("animate", cfg.animate)
    cfg.bilateral = c.get_bool("bilateral", cfg.bilateral)
    cfg.processed = c.get_bool("processed", cfg.processed)
    cfg.refine = c.get_bool("refine", cfg.refine)
    cfg.colorfill = c.get_bool("colorfill", cfg.colorfill)
    cfg.bricking = c.get_bool("bricking", cfg.bricking)
    cfg.skip_space = c.get_bool("skip_space", cfg.skip_space)
    cfg.watch_errors = c.get_bool("watch_errors", cfg.watch_errors)
    cfg.voxel_size = c.get_float("voxel_size", cfg.voxel_size)
    cfg.brick_size = c.get_float("brick_size", cfg.brick_size)
    cfg.tsdf_limit = c.get_float("tsdf_limit", cfg.tsdf_limit)
    cfg.zoom = c.get_float("zoom", cfg.zoom)
    cfg.time_limit = c.get_uint("time_limit", cfg.time_limit)
    cfg.loaded_conf = True
    cfg.conf_file = file_name


# recon_mode indices (GUI radio buttons, kinect_client.cpp:344-347)
MODE_NAMES = {0: "points", 1: "integration", 2: "trigrid", 3: "mvt"}
INTEGRATION = 1


def _host(t: torch.Tensor, device: torch.device):
    """(pinned host copy, CUDA event) of ``t``, the copy issued without
    blocking the caller; (the tensor, None) off the card."""
    if device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class FrameMonitor:
    """Per-frame watchdog + completion fence, off the render loop.

    The reference's GL error watchdog checks every frame
    (kinect_client.cpp:1017-1049). A read of the frame's values from the
    render loop would stall it until the device finishes, so the loop
    submits each frame's fence instead — the all-finite flag and the
    occupied-brick count, a 2-element tensor — and ``workers`` reader
    threads check it a few frames late: non-finite pixels and brick
    overflow are still detected for EVERY frame. On the card ``submit``
    issues a ``non_blocking`` copy of the fence (and, every
    ``publish_every`` frames with a viewer, of the frame) into pinned
    memory and records an event; the worker waits on that event alone. (A
    ``.cpu()`` from a worker thread would run on the default stream and
    queue behind the frames the loop enqueued since.) The brick capacity is
    captured at submit, so a retune between submit and check does not
    change the limit a frame is held to. The bounded queue gives
    backpressure: the loop runs at most ``depth`` frames ahead of verified
    completion, so the wall FPS the app reports is a completion rate."""

    def __init__(self, device: torch.device, viewer=None, workers: int = 3,
                 depth: int = 8, publish_every: int = 10):
        self.device = device
        self.viewer = viewer
        self.publish_every = publish_every
        self.error: BaseException | None = None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._threads = [
            threading.Thread(target=self._worker, name=f"frame-mon-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, frame_no: int, fence: torch.Tensor, rgba: torch.Tensor,
               max_bricks: int | None) -> None:
        """Called from the render loop. ``fence``: i32[2] (finite flag,
        occupied bricks) computed right after the frame; ``max_bricks``: the
        capacity to hold the count to (None: not checked). Blocks when
        ``depth`` frames are pending (backpressure)."""
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        fence_h, event = _host(fence, self.device)
        frame_h = None
        if self.viewer is not None and frame_no % self.publish_every == 0:
            frame_h, event = _host(rgba, self.device)
        self._q.put((frame_no, fence_h, frame_h, event, max_bricks))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            frame_no, fence, frame, event, max_bricks = item
            try:
                if event is not None:
                    event.synchronize()
                finite_ok, n_occ = bool(fence[0]), int(fence[1])
                if not finite_ok:
                    raise RuntimeError(f"watch_errors: non-finite values in frame {frame_no}")
                if max_bricks is not None and n_occ > max_bricks:
                    raise RuntimeError(
                        f"occupied bricks {n_occ} exceed max_bricks={max_bricks}: "
                        f"geometry dropped (frame {frame_no})")
                if frame is not None:
                    self.viewer.publish(frame.numpy())
            except Exception as e:  # surfaced on the next submit/drain
                self.error = e
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every pending frame is verified; re-raise errors."""
        self._q.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)


class KinectClientApp:
    """Headless reconstruction client. See module docstring."""

    def __init__(self, ks_path: str, cfg: AppConfig,
                 server_socket: str = "127.0.0.1:7000",
                 recordings_dir: str = "recordings",
                 out_dir: str = "frames",
                 dump_every: int = 0,
                 dump_textures: bool = False,
                 feedback_socket: str | None = None,
                 max_frames: int | None = None,
                 serve_port: int | None = None,
                 device: torch.device | str = "cuda",
                 log=print):
        self.cfg = cfg
        self.device = torch.device(device)
        self.out_dir = out_dir
        self.dump_every = dump_every
        self.dump_textures = dump_textures
        self.max_frames = max_frames
        self.log = log
        self.viewer = None
        if serve_port is not None:
            self.viewer = LiveViewer(serve_port)
            log(f"live viewer at http://localhost:{self.viewer.port}/")

        self.log(f"loading scene {ks_path}")
        self.calib_files, self.rig, self.fmt, self.bbox = load_scene(ks_path)

        # side-by-side mode runs without depth-aware color filling
        # (kinect_client.cpp:641-644 setColorFilling(false))
        fill_holes = cfg.colorfill and cfg.stereo_mode != 2
        self.pipeline = FramePipeline(
            self.rig,
            PipelineConfig(
                render_width=cfg.screen_width, render_height=cfg.screen_height,
                voxel_size=cfg.voxel_size, brick_size=cfg.brick_size,
                tsdf_limit=cfg.tsdf_limit,
                use_bricks=cfg.bricking, skip_space=cfg.skip_space,
                fill_holes=fill_holes,
                filter_textures=cfg.bilateral,
                use_processed_depth=cfg.processed,
                refine_boundary=cfg.refine,
            ),
            log=lambda s: self.log(f"[pipeline] {s}"),
            device=self.device,
        )
        self.log(f"volume res {self.pipeline.tsdf_cfg.res} at voxel_size "
                 f"{cfg.voxel_size} on {self.device}")
        self.stereo = None
        if cfg.stereo_mode in (1, 2):
            # init_stereo_camera (kinect_client.cpp:128-148)
            self.stereo = StereoCamera(screen_width=cfg.screen_width_real,
                                       screen_height=cfg.screen_height_real)
        ctx = ReconContext(rig=self.rig, bbox=self.bbox, width=cfg.screen_width,
                           height=cfg.screen_height, device=self.device,
                           log=lambda s: self.log(f"[models] {s}"))
        # strategy vector indexed by recon_mode (kinect_client.cpp:249-255)
        self.models = {0: ReconPoints(ctx), 2: ReconTrigrid(ctx), 3: ReconMVT(ctx)}
        self.calibvis = ReconCalibs(ctx)

        # navigation (kinect_client.cpp:537-567 uses the navigator's matrix)
        self.navigator = CameraNavigator(zoom=cfg.zoom)
        self.navigator.resize(cfg.screen_width, cfg.screen_height)
        self.proj = perspective(50.0, cfg.screen_width / cfg.screen_height, 0.1, 200.0)

        # frame source
        self.ingest = None
        self.reader = None
        self._wire_decode = self._make_wire_decoder()
        if cfg.play:
            paths = []
            for yml in self.calib_files.filenames:
                base = os.path.basename(yml)[:-4]
                paths.append(os.path.join(recordings_dir, base + ".stream"))
            for p in paths:
                if not os.path.exists(p):
                    self.log(f"error opening {p} exiting...")  # :720-723
                    raise FileNotFoundError(p)
            self.reader = StreamReader(paths, self.fmt, looping=True)
            self.log(f"replaying {len(paths)} streams, {len(self.reader)} frames")
        else:
            # u8 color stays u8 until the device; with the wire decoder the
            # ingest thread keeps the raw payload bytes and decodes nothing
            self.ingest = ZMQIngest(
                server_socket, self.calib_files.num, self.fmt, color_u8=True,
                raw_wire=self._wire_decode is not None,
            )
            self.ingest.start()
            # device staging overlaps the upload with the previous frame
            self.feed = DeviceFeed(self.device)
            self.log(f"subscribed to tcp://{server_socket}")

        self.feedback = None
        if feedback_socket:
            self.feedback = FeedbackReceiver(feedback_socket)
            self.feedback.start()

        self._frustum_corners = None
        if cfg.draw_frustums:
            self._get_frustum_corners()

        self._frames_done = 0
        self._t_warm = None   # wall time when the first (session-bake) frame finished
        # per-stage sampling cadence: step_timed synchronises the device at
        # its end, so it runs every Nth frame and the other frames stay
        # asynchronous
        self.timed_every = int(os.environ.get("RGBD_TIMED_EVERY", "30"))
        self.monitor = FrameMonitor(self.device, viewer=self.viewer)
        db = TimerDatabase.instance()
        for t in ("draw", "1preprocess", "2integrate", "3recon", "holefill"):
            db.add_timer(t)

    # ------------------------------------------------------------------
    # runtime control channel: the headless equivalent of the reference's
    # keybindings + ImGui panel (kinect_client.cpp:732-807, :318-480) —
    # commands arrive over the viewer's POST /control (or apply_control
    # directly) and mutate the state the keys did: retune() for
    # voxel/brick/tsdf/min-voxel changes, config rebuilds for filter/fill
    # toggles (the warp bakes survive), plain state for overlays/zoom.

    # control key -> PipelineConfig field for toggles that rebuild the
    # pipeline's config-derived state
    _PIPE_FLAGS = {
        "colorfill": "fill_holes", "bricking": "use_bricks",
        "skip_space": "skip_space", "bilateral": "filter_textures",
        "processed": "use_processed_depth", "refine": "refine_boundary",
        "shade_mode": "shade_mode",
    }

    @staticmethod
    def _as_bool(v) -> bool:
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return bool(v)

    def apply_control(self, cmd: dict) -> None:
        """Apply one control command ({key: value, ...})."""
        cfg = self.cfg
        retune = {}
        pipe_updates = {}
        for k, v in cmd.items():
            if k in ("voxel_size", "brick_size", "tsdf_limit"):
                v = float(v)
                if v > 0 and v != getattr(cfg, k):
                    retune[k] = v
                    setattr(cfg, k, v)
            elif k == "min_voxels_per_brick":
                if int(v) != self.pipeline.cfg.min_voxels_per_brick:
                    retune[k] = int(v)
            elif k in self._PIPE_FLAGS:
                field = self._PIPE_FLAGS[k]
                val = int(v) if k == "shade_mode" else self._as_bool(v)
                if k == "colorfill":
                    # side-by-side runs without depth-aware fill
                    # (kinect_client.cpp:641-644)
                    cfg.colorfill = bool(val)
                    val = bool(val) and cfg.stereo_mode != 2
                elif hasattr(cfg, k):
                    setattr(cfg, k, val)
                if val != getattr(self.pipeline.cfg, field):
                    pipe_updates[field] = val
            elif k == "recon_mode":
                m = int(v)
                if m in MODE_NAMES and m != cfg.recon_mode:
                    self.log(f"control: recon_mode -> {MODE_NAMES[m]}")
                    cfg.recon_mode = m
            elif k == "zoom":
                cfg.zoom = float(v)
                self.navigator.set_zoom(float(v))
            elif k in ("animate", "draw_grid", "draw_frustums",
                       "draw_bricks", "play", "watch_errors"):
                setattr(cfg, k, self._as_bool(v))
            else:
                self.log(f"control: unknown key {k!r} ignored")
        if retune:
            self.log(f"control: retune {retune}")
            self.pipeline.retune(**retune)
        if pipe_updates:
            self.log(f"control: pipeline flags {pipe_updates}")
            self.pipeline._configure(self.pipeline.cfg._replace(**pipe_updates),
                                     keep_warp_bake=True)
            if "use_bricks" in pipe_updates:
                p = self.pipeline
                self.log(f"control: bricking {'on' if p.cfg.use_bricks else 'off'}: volume "
                         f"res {p.tsdf_cfg.res} ({'brick-sparse' if p.use_fast else 'reference'}"
                         " path)")

    def _control_state(self) -> dict:
        cfg = self.cfg
        p = self.pipeline.cfg
        return {
            "recon_mode": cfg.recon_mode, "shade_mode": p.shade_mode,
            "voxel_size": p.voxel_size, "brick_size": p.brick_size,
            "tsdf_limit": p.tsdf_limit,
            "min_voxels_per_brick": p.min_voxels_per_brick,
            "zoom": cfg.zoom, "colorfill": cfg.colorfill,
            "bricking": p.use_bricks, "skip_space": p.skip_space,
            "bilateral": p.filter_textures, "animate": cfg.animate,
            "draw_grid": cfg.draw_grid,
        }

    def _drain_controls(self) -> None:
        if self.viewer is None:
            return
        cmds = self.viewer.poll_controls()
        for cmd in cmds:
            try:
                self.apply_control(cmd)
            except Exception as e:   # a bad command must not kill the loop
                self.log(f"control error ({cmd}): {type(e).__name__}: {e}")
        if cmds or self._frames_done == 0:
            self.viewer.publish_state(self._control_state())

    def _make_wire_decoder(self):
        """Device-side wire decode (ops/wire.py): upload the raw stream
        bytes and decode DXT1/compressed depth on the device — the
        reference's GL-native S3TC + in-shader depth decode. RGBD_WIRE_DECODE:
        auto (default: on for compressed streams on a CUDA device), 1
        (force), 0 (host decode)."""
        want = os.environ.get("RGBD_WIRE_DECODE", "auto")
        compressed = self.fmt.compressed_rgb or self.fmt.compressed_depth
        if want == "1" or (want == "auto" and compressed and self.device.type == "cuda"):
            self.log("wire decode: on-device "
                     f"({self.fmt.frame_size / 1e6:.2f} MB/frame/sensor on the wire)")
            return make_wire_decoder(self.fmt)
        return None

    def _get_frustum_corners(self) -> np.ndarray:
        """The 8 cv_xyz corner samples per sensor (CalibVolumes.cpp:98-113)."""
        if self._frustum_corners is None:
            v = self.rig.cv_xyz
            ez, ey, ex = (int(s) - 1 for s in v.shape[1:4])
            picks = [(0, 0, 0), (0, ey, 0), (0, ey, ex), (0, 0, ex),
                     (ez, 0, 0), (ez, ey, 0), (ez, ey, ex), (ez, 0, ex)]
            self._frustum_corners = np.stack(
                [np.stack([np.asarray(v[k, z, y, x]) for (z, y, x) in picks])
                 for k in range(v.shape[0])])
        return self._frustum_corners

    def _acquire(self):
        """Next sensor frame (depth, color) — numpy arrays or tensors on the
        device — or None. Live frames go through the DeviceFeed so the
        upload of frame N+1 overlaps frame N's compute (≙ the reference's
        double-PBO handoff)."""
        if self.reader is not None:
            if self._wire_decode is None:
                return self.reader.read()
            raw = self.reader.read_raw()
            if raw is None:
                return None
            cp, dp = (torch.from_numpy(a).to(self.device) for a in raw)
            return self._wire_decode(cp, dp)
        swap = self.ingest.buffer.swap_if_dirty()
        if swap is not None:
            self.feed.stage(*swap)
        got = self.feed.advance()
        if got is not None and self._wire_decode is not None:
            d_pay, c_pay = got       # raw payload bytes, staged on the device
            return self._wire_decode(c_pay, d_pay)
        return got

    def _render_view(self, depth, color, mv, proj, recon_mode=None, timed=False):
        """Render one view with the given camera. Returns (rgba, pipeline
        FrameOutput or None, preprocessed frames or None): integration runs
        the pipeline's step, the other modes their strategy's timed draw on
        the pipeline's preprocessed frames."""
        mode = self.cfg.recon_mode if recon_mode is None else recon_mode
        if mode == INTEGRATION:
            step = self.pipeline.step_timed if timed else self.pipeline.step
            out = step(depth, color, mv, proj)
            return out.color, out, None
        frames = self.pipeline.preprocess(depth, color)
        cam = RenderCamera(torch.as_tensor(np.asarray(mv, np.float32), device=self.device),
                           torch.as_tensor(np.asarray(proj, np.float32), device=self.device),
                           self.cfg.screen_width, self.cfg.screen_height)
        return self.models[mode].draw_f(frames, cam), None, frames

    def _mono_overlays(self, rgba, out, frames, mv):
        """draw_grid / draw_frustums / draw_bricks wireframes, mono mode
        only (kinect_client.cpp:672-708); a host image when one is drawn."""
        cfg = self.cfg
        bricks = cfg.draw_bricks and cfg.recon_mode != INTEGRATION and frames is not None
        if not (cfg.draw_grid or cfg.draw_frustums or bricks):
            return rgba
        img = rgba.cpu().numpy()
        # the splatting strategies keep no depth buffer: wires draw untested
        depth_buf = out.depth.cpu().numpy() if out is not None else None
        if cfg.draw_grid:       # g_bbox.draw() (kinect_client.cpp:703-705)
            img = overlay.draw_segments(img, overlay.bbox_segments(self.bbox), mv,
                                        self.proj, color=(1.0, 1.0, 1.0, 1.0),
                                        depth=depth_buf)
        if cfg.draw_frustums:   # CalibVolumes::drawFrustums
            corners = self._get_frustum_corners()
            for k in range(corners.shape[0]):
                img = overlay.draw_segments(img, overlay.frustum_segments(corners[k]), mv,
                                            self.proj, color=(0.0, 1.0, 0.0, 1.0),
                                            depth=depth_buf)
        if bricks:
            # drawOccupiedBricks runs only when integration is NOT the
            # active mode (kinect_client.cpp:682-684)
            grid = self.pipeline.brick_grid
            counts = brick_ops.mark_bricks(frames.world, frames.world_valid, grid)
            mask = brick_ops.occupancy_mask(counts, 10).cpu().numpy()
            img = overlay.draw_segments(img, overlay.brick_segments(mask, grid), mv, self.proj,
                                        color=(1.0, 0.1, 0.1, 1.0), depth=depth_buf)
        return img

    def frame_step(self):
        """One frame: acquire + reconstruct (≙ frameStep/draw3d,
        kinect_client.cpp:580-670 incl. the three stereo modes). Returns the
        frame (a tensor on the device, or a host array for stereo
        composites and overlays), or None when no frame was available."""
        self._drain_controls()
        got = self._acquire()
        if got is None:
            return None
        depth, color = got
        cfg = self.cfg
        if cfg.animate:
            self.navigator.orbit(2.0 * np.pi * (self._frames_done % 360) / 360.0)
        mv = self.navigator.modelview()

        db = TimerDatabase.instance()
        # sampled per-stage timing: step_timed adds a device sync, so it
        # runs every timed_every-th frame; the other frames stay async
        timed = (self._frames_done % self.timed_every == 0)
        if timed or cfg.stereo_mode != 0:
            db.begin("draw")
        out = None
        if cfg.stereo_mode == 1:        # ANAGLYPH (kinect_client.cpp:616-633)
            lmv, lproj = self.stereo.eye_view("left")
            rmv, rproj = self.stereo.eye_view("right")
            # update_model_matrix(false): navigation multiplies ON TOP of
            # the stereo modelview
            left = self._render_view(depth, color, lmv @ mv, lproj)[0]
            right = self._render_view(depth, color, rmv @ mv, rproj)[0]
            rgba = anaglyph_composite(left.cpu().numpy(), right.cpu().numpy(),
                                      cfg.clear_color[3])
        elif cfg.stereo_mode == 2:      # SIDE-BY-SIDE (:634-670)
            fb = self.feedback.get() if self.feedback is not None else None
            mode = cfg.recon_mode
            model_mat = mv
            if fb is not None:
                self.stereo.set_cyclops_matrix(fb["cyclops"])
                self.stereo.set_screen_matrix(fb["screen"])
                model_mat = fb["model"].astype(np.float32)
                mode = int(fb["recon_mode"])
            lmv, lproj = self.stereo.eye_view("left")
            rmv, rproj = self.stereo.eye_view("right")
            left = self._render_view(depth, color, lmv @ model_mat, lproj, recon_mode=mode)[0]
            right = self._render_view(depth, color, rmv @ model_mat, rproj, recon_mode=mode)[0]
            rgba = side_by_side_composite(
                (cfg.window_height, cfg.window_width),
                left.cpu().numpy(), cfg.left_pos, right.cpu().numpy(), cfg.right_pos)
        else:                           # MONO (:609-615)
            rgba, out, frames = self._render_view(depth, color, mv, self.proj, timed=timed)
            rgba = self._mono_overlays(rgba, out, frames, mv)
        if timed or cfg.stereo_mode != 0:
            db.end("draw", sync=rgba if isinstance(rgba, torch.Tensor) else None)
            if self._t_warm is None:
                self._t_warm = time.time()   # frame 1 = session-bake frame
        self._frames_done += 1
        if cfg.animate and cfg.recon_mode == INTEGRATION and self._frames_done == 1:
            # an orbit crosses sweep axes: the JAX app warms the other
            # render variants here (a logged no-op in eager PyTorch)
            self.pipeline.warm_variants_async(depth, color, mv, self.proj)

        # device frames go through the asynchronous watchdog: a 2-element
        # (finite flag, brick count) fence per frame, read by monitor
        # threads off the render loop. Stereo composites and overlay frames
        # are host arrays already, so they are checked inline.
        if isinstance(rgba, np.ndarray):
            if cfg.watch_errors:
                # ≙ watch_gl_errors (kinect_client.cpp:1017-1049)
                if not np.all(np.isfinite(rgba)):
                    raise RuntimeError(
                        f"watch_errors: non-finite values in frame {self._frames_done}")
                if out is not None:
                    self.pipeline.check_capacity(out)
            if self.viewer is not None:
                self.viewer.publish(rgba)
        else:
            fin = (torch.isfinite(rgba).all() if cfg.watch_errors
                   else torch.ones((), dtype=torch.bool, device=rgba.device))
            occ = (out.occupied_bricks.to(torch.int32) if out is not None
                   else torch.zeros((), dtype=torch.int32, device=rgba.device))
            fence = torch.stack([fin.to(torch.int32), occ])
            self.monitor.submit(self._frames_done, fence, rgba,
                                self.pipeline.max_bricks
                                if cfg.watch_errors and out is not None else None)
        if self.dump_every and self._frames_done % self.dump_every == 0:
            self._dump_frame(rgba, depth, color)
        return rgba

    def _dump_frame(self, rgba, depth, color):
        os.makedirs(self.out_dir, exist_ok=True)
        n = self._frames_done
        img = rgba.cpu().numpy() if isinstance(rgba, torch.Tensor) else rgba
        write_png(os.path.join(self.out_dir, f"frame_{n:05d}.png"), img)
        if self.dump_textures:
            # ≙ writeCurrentTexture per-sensor dumps (NetKinectArray.cpp:531+),
            # preprocessed with the pipeline's own session bakes
            frames = self.pipeline.preprocess(depth, color)
            for k in range(frames.depth.shape[0]):
                pre = os.path.join(self.out_dir, f"frame_{n:05d}_k{k}_")
                write_png(pre + "depth.png", frames.depth[k, ..., 0].cpu().numpy())
                write_png(pre + "silhouette.png", frames.silhouette[k].cpu().numpy())
                write_png(pre + "quality.png", frames.quality[k].cpu().numpy() * 20.0)
                write_png(pre + "normals.png", frames.normals[k].cpu().numpy() * 0.5 + 0.5)
                write_png(pre + "color.png", frames.color_registered[k].cpu().numpy())

    def run(self) -> int:
        """Main loop with time_limit auto-quit (kinect_client.cpp:1003-1012)."""
        cfg = self.cfg
        start = time.time()
        last_report = start
        frames_at_report = 0
        while True:
            rgba = self.frame_step()
            if rgba is None:
                if self.reader is not None:
                    break  # non-looping EOF
                time.sleep(0.005)
            now = time.time()
            if now - last_report >= 2.0:
                fps = (self._frames_done - frames_at_report) / (now - last_report)
                self.log(f"fps: {fps:.2f} ({self._frames_done} frames)")
                last_report = now
                frames_at_report = self._frames_done
            if cfg.loaded_conf and cfg.time_limit and now - start >= cfg.time_limit:
                break
            if self.max_frames is not None and self._frames_done >= self.max_frames:
                break
        # wall FPS over VERIFIED completions (the monitor's fences prove the
        # device finished each frame)
        self.monitor.drain()
        t_end = time.time()
        if self._frames_done:
            self.log(f"app wall fps: {self._frames_done / (t_end - start):.2f} "
                     f"over {self._frames_done} frames incl. the session bakes")
        if self._t_warm is not None and self._frames_done > 1 and t_end > self._t_warm:
            self.log(f"app steady fps: {(self._frames_done - 1) / (t_end - self._t_warm):.2f} "
                     f"(excl. the first frame)")
        return self.quit()

    def quit(self) -> int:
        """CSV export on quit (kinect_client.cpp:831-847)."""
        try:
            self.monitor.drain()
        finally:
            self.monitor.close()
            if self.viewer is not None:
                self.viewer.close()
            if self.ingest is not None:
                self.ingest.stop()
            if self.feedback is not None:
                self.feedback.stop()
            if self.reader is not None:
                self.reader.close()
        if self.cfg.loaded_conf:
            now = time.localtime()
            base = self.cfg.conf_file[:-5] if self.cfg.conf_file.endswith(".conf") \
                else self.cfg.conf_file
            file_name = (f"{base},{now.tm_year}-{now.tm_mon}-{now.tm_mday},"
                         f"{now.tm_hour}-{now.tm_min}.csv")
            db = TimerDatabase.instance()
            db.write_mean(file_name)
            db.write_min(file_name)
            db.write_max(file_name)
            self.log(f"wrote timer CSVs for {file_name}")
        self.log(f"done: {self._frames_done} frames")
        return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = CMDParser("python -m rgbd_recon_torch.app <scene.ks> [run.conf]")
    p.add_opt("s", 2, "screensize", "set screen size in meter")
    p.add_opt("d", 2, "displaysize", "set display size in pixel")
    p.add_opt("w", 2, "windowsize", "set window size in pixel for stereomode side-by-side")
    p.add_opt("l", 2, "leftpos", "left viewport position (stereo)")
    p.add_opt("r", 2, "rightpos", "right viewport position (stereo)")
    p.add_opt("m", 1, "stereomode", "stereo mode 0: none, 1: anaglyph, 2: side-by-side")
    p.add_opt("c", 4, "clearcolor", "clear color")
    p.add_opt("f", 1, "feedbacksocket", "socket for feedback receiver")
    p.add_opt("p", 1, "serversocket", "server socket for input stream")
    # headless extensions
    p.add_opt("recordings", 1, "recordings", "directory with .stream recordings")
    p.add_opt("outdir", 1, "outdir", "PNG output directory")
    p.add_opt("dump-every", 1, "dump_every", "dump a PNG every N frames")
    p.add_opt("dump-textures", 0, "dump_textures", "also dump processed sensor textures")
    p.add_opt("frames", 1, "frames", "stop after N frames")
    p.add_opt("serve", 1, "serve", "serve the live frame stream over HTTP on this port")
    p.add_opt("draw-frustums", 0, "draw_frustums", "overlay calibration frustum wireframes")
    p.add_opt("draw-bricks", 0, "draw_bricks", "overlay occupied-brick wireframes (modes != 1)")
    p.add_opt("device", 1, "device", "torch device: cuda (default) or cpu")
    p.init(argv)

    cfg = AppConfig()
    args = p.args
    if not args or not args[0].endswith(".ks"):
        raise SystemExit("No .ks file specified")
    if len(args) > 1:
        if not args[1].endswith(".conf"):
            raise SystemExit("No .conf file specified")
        load_config(cfg, args[1])
    if p.is_opt_set("d"):
        cfg.screen_width, cfg.screen_height = p.get_opts_int("d")
    # stereo geometry (kinect_client.cpp:888-930)
    if p.is_opt_set("s"):
        cfg.screen_width_real, cfg.screen_height_real = p.get_opts_float("s")
    if p.is_opt_set("w"):
        cfg.window_width, cfg.window_height = p.get_opts_int("w")
    if p.is_opt_set("l"):
        cfg.left_pos = tuple(p.get_opts_int("l"))
    if p.is_opt_set("r"):
        cfg.right_pos = tuple(p.get_opts_int("r"))
    if p.is_opt_set("m"):
        cfg.stereo_mode = int(p.get_opts_int("m")[0])
    if p.is_opt_set("c"):
        cfg.clear_color = tuple(p.get_opts_float("c"))
    if p.is_opt_set("draw-frustums"):
        cfg.draw_frustums = True
    if p.is_opt_set("draw-bricks"):
        cfg.draw_bricks = True
    server_socket = p.get_opts_string("p")[0] if p.is_opt_set("p") else "127.0.0.1:7000"
    if p.is_opt_set("p"):
        cfg.play = False  # explicit live source

    def opt(name, conv, default):
        return conv(p.get_opts_string(name)[0]) if p.is_opt_set(name) else default

    app = KinectClientApp(
        args[0], cfg,
        server_socket=server_socket,
        recordings_dir=opt("recordings", str, "recordings"),
        out_dir=opt("outdir", str, "frames"),
        dump_every=opt("dump-every", int, 0),
        dump_textures=p.is_opt_set("dump-textures"),
        feedback_socket=opt("f", str, None),
        max_frames=opt("frames", int, None),
        serve_port=opt("serve", int, None),
        device=opt("device", str, "cuda"),
    )
    return app.run()


if __name__ == "__main__":
    raise SystemExit(main())
