"""Live ZMQ frame ingest + double-buffered host->device feeding (mirrors
``rgbd_recon_tpu/io/ingest.py``).

≙ the reference's NetKinectArray ingest thread + persistent-mapped PBO pair
(NetKinectArray::readLoop, NetKinectArray.cpp:482-529; double_pbo,
double_pixel_buffer.cpp:10-103): a SUB socket with RCVHWM=1 receives
``[f64 timestamp][K x (color, depth)]`` messages; the render side swaps in the
latest complete frame. ``DeviceFeed`` is the PBO pair: two pinned host
buffers and a copy stream, so frame N+1's upload overlaps frame N's compute.

``zmq`` is imported where a socket is opened, not with the module: replay
needs none, and the card's machine has no pyzmq.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .stream import FrameFormat


class DoubleBuffer:
    """Front/back swap with a dirty flag (≙ double_buffer.hpp:6-33)."""

    def __init__(self, shape_depth, shape_color, color_dtype=np.float32,
                 depth_dtype=np.float32):
        self._depth = [np.zeros(shape_depth, depth_dtype) for _ in range(2)]
        self._color = [np.zeros(shape_color, color_dtype) for _ in range(2)]
        self._front = 0
        self.dirty = False
        self.lock = threading.Lock()
        self.timestamp = 0.0

    @property
    def back_depth(self):
        return self._depth[1 - self._front]

    @property
    def back_color(self):
        return self._color[1 - self._front]

    def swap_if_dirty(self) -> Optional[tuple[np.ndarray, np.ndarray, float]]:
        """Render-thread side of update() (NetKinectArray.cpp:224-236)."""
        with self.lock:
            if not self.dirty:
                return None
            self._front = 1 - self._front
            self.dirty = False
            return self._depth[self._front], self._color[self._front], self.timestamp

    def publish(self, ts: float) -> None:
        with self.lock:
            self.timestamp = ts
            self.dirty = True


class _SubThread:
    """A daemon thread on a SUB socket handing each message to
    ``_on_message`` until ``stop``."""

    def __init__(self, endpoint: str):
        import zmq  # noqa: F401  (fail at construction, not in the thread)

        self._endpoint = endpoint
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        import zmq

        ctx = zmq.Context(1)
        sock = ctx.socket(zmq.SUB)
        sock.setsockopt(zmq.SUBSCRIBE, b"")
        sock.setsockopt(zmq.RCVHWM, 1)  # keep only the newest (NetKinectArray.cpp:489)
        sock.setsockopt(zmq.RCVTIMEO, 200)  # wake to check for a stop
        sock.connect(f"tcp://{self._endpoint}")
        try:
            while self._running:
                try:
                    msg = sock.recv()
                except zmq.Again:
                    continue
                self._on_message(msg)
        finally:
            sock.close(0)
            ctx.term()


class ZMQIngest(_SubThread):
    """SUB-socket reader thread (≙ readLoop). Wire layout per message:
    ``[f64 time][K1 color][K1 depth][K2 color][K2 depth]...``
    (NetKinectArray.cpp:510-523)."""

    def __init__(self, endpoint: str, num_sensors: int, fmt: FrameFormat,
                 color_u8: bool = False, raw_wire: bool = False):
        """``raw_wire``: keep the WIRE payload bytes (no host decode at
        all) — the app then uploads them as-is and decodes on the device
        (ops/wire.py)."""
        super().__init__(endpoint)
        self.fmt = fmt
        self.num_sensors = num_sensors
        self.color_u8 = color_u8
        self.raw_wire = raw_wire
        if raw_wire:
            self.buffer = DoubleBuffer(
                (num_sensors, fmt.depth_size),
                (num_sensors, fmt.color_size),
                color_dtype=np.uint8, depth_dtype=np.uint8,
            )
        else:
            self.buffer = DoubleBuffer(
                (num_sensors, fmt.height, fmt.width),
                (num_sensors, fmt.height_c, fmt.width_c, 3),
                color_dtype=np.uint8 if color_u8 else np.float32,
            )

    def _on_message(self, msg: bytes) -> None:
        fmt = self.fmt
        if len(msg) < 8 + fmt.frame_size * self.num_sensors:
            return
        ts = np.frombuffer(msg[:8], np.float64)[0]
        off = 8
        for k in range(self.num_sensors):
            raw = np.frombuffer(msg[off: off + fmt.color_size], np.uint8)
            self.buffer.back_color[k] = raw if self.raw_wire else fmt.decode_color(
                raw, as_float=not self.color_u8)
            off += fmt.color_size
            raw = np.frombuffer(msg[off: off + fmt.depth_size], np.uint8)
            self.buffer.back_depth[k] = raw if self.raw_wire else fmt.decode_depth(raw)
            off += fmt.depth_size
        self.buffer.publish(float(ts))


class DeviceFeed:
    """Host->device staging that overlaps the upload with compute.

    ≙ the reference's persistent-mapped PBO pair + fillLayersFromPBO
    (double_pixel_buffer.cpp:10-103, TextureArray.cpp:75-87). On a CUDA
    device ``stage`` copies the frame into one of two pinned host buffer
    sets and issues its ``non_blocking`` upload on a side stream, recording
    an event; ``advance`` makes the consumer's stream wait on that event and
    marks the tensors as used there (``record_stream``), so the caching
    allocator does not hand their memory to the next upload while the frame
    still reads it. A pinned set is rewritten only after the upload that
    last read it has finished. On the CPU the frame is copied.

    Use (once per loop):
        feed.stage(depth_np, color_np)   # upload for this or a later frame
        staged = feed.advance()          # device tensors of the newest stage
    """

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pinned: list = [None, None]   # per set: (host tensors, upload event)
        self._set = 0
        self._current = None
        self._next = None
        self.timestamp = 0.0

    def stage(self, depth: np.ndarray, color: np.ndarray, ts: float = 0.0) -> None:
        self.timestamp = ts
        if not self._cuda:
            self._next = (torch.tensor(depth), torch.tensor(color)), None
            return
        slot = self._pinned[self._set]
        arrays = (depth, color)
        if slot is None or any(h.shape != a.shape for h, a in zip(slot[0], arrays)):
            host = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                     pin_memory=True) for a in arrays)
        else:
            host, done = slot
            done.synchronize()   # the upload that last read this set
        for h, a in zip(host, arrays):
            h.numpy()[...] = a
        with torch.cuda.stream(self._stream):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pinned[self._set] = (host, event)
        self._set = 1 - self._set
        self._next = dev, event

    def current(self):
        """Device tensors of the most recently advanced stage (None until a
        frame has been staged and advanced)."""
        return self._current

    def advance(self):
        """The staged frame becomes current, ordered after its upload on the
        caller's stream (call once per loop)."""
        if self._next is not None:
            tensors, event = self._next
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in tensors:
                    t.record_stream(consumer)
            self._current = tensors
            self._next = None
        return self._current


class FeedbackSender:
    """Publishes ``feedback`` structs for head-tracked stereo viewers — the
    counterpart of the reference's FeedbackReceiver (io/FeedbackReceiver.h:
    17-47): 3 column-major f32[16] matrices + i32 recon mode."""

    @staticmethod
    def pack(cyclops: np.ndarray, screen: np.ndarray, model: np.ndarray, mode: int) -> bytes:
        out = b"".join(
            np.asarray(m, np.float32).T.tobytes() for m in (cyclops, screen, model)
        )
        return out + np.int32(mode).tobytes()


class FeedbackReceiver(_SubThread):
    """SUB thread for viewer feedback (≙ io/FeedbackReceiver.cpp:14-71)."""

    STRUCT_BYTES = 16 * 4 * 3 + 4

    def __init__(self, endpoint: str):
        super().__init__(endpoint)
        self._lock = threading.Lock()
        self._value = None

    def get(self):
        with self._lock:
            return self._value

    def _on_message(self, msg: bytes) -> None:
        if len(msg) < self.STRUCT_BYTES:
            return
        mats = np.frombuffer(msg[: 16 * 4 * 3], np.float32).reshape(3, 4, 4)
        mode = int(np.frombuffer(msg[16 * 4 * 3: 16 * 4 * 3 + 4], np.int32)[0])
        with self._lock:
            # stored column-major on the wire
            self._value = dict(cyclops=mats[0].T, screen=mats[1].T, model=mats[2].T,
                               recon_mode=mode)
