"""Asyncio serving runtime: RTSP-like control plane + RTP-like data plane.

Protocol-compatible rewrite of the reference's single-threaded selectors
server (server/server.py:140-327), redesigned around two properties the
reference lacks (SURVEY.md §3.2):

- **No head-of-line blocking.** The reference runs inference synchronously
  on the event-loop thread, so one slow frame stalls every session. Here
  device dispatch is async: the loop keeps pumping sockets while the card
  runs, and result fetch happens on an executor thread.
- **Cross-client batching.** Each model has a ModelService with a
  continuous batcher: whatever requests are queued when the device goes
  idle form the next batch (up to the engine's max bucket). Under load,
  batches grow and per-frame cost amortizes on the device; when idle, a
  single request ships immediately with zero added window latency.

Wire behavior kept bit-compatible (reference cites in fastdet_tpu_torch.wire):

- ``FEED lport path`` -> ``+OK port sessionid`` handshake, errors
  ``!UNKNOWN`` / ``!INVALID`` (server.py:267-310),
- per-session ephemeral UDP socket, 12-byte init packet, seqno starts 1,
- RTP reassembly with gap-cancel semantics; packets from a foreign
  address are ignored (server.py:206-223),
- request/response payload layouts and 40000-byte response chunking.

Documented divergences: a malformed/wrong-size image produces an empty
result response instead of killing the whole server (the reference lets
the ValueError from detector.perform unwind its event loop); session idle
timeout is actually enforced (the reference stores timeout=10 but never
uses it, server.py:184,190).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from fastdet_tpu_torch import wire
from fastdet_tpu_torch.runtime.detector import Detector, DummyDetector
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES
from fastdet_tpu_torch.wire.messages import ResultTuple

logger = logging.getLogger(__name__)

SESSION_IDLE_TIMEOUT = 60.0   # seconds without datagrams before teardown


class ModelService:
    """Continuous batcher in front of one DetectionEngine.

    submit() resolves when the request's results are ready. The worker
    collects every queued request (up to the engine's largest bucket) the
    moment the engine is free — batch size adapts to load automatically.
    """

    # Emit a stage-timing summary to the log every this many batches.
    STATS_EVERY = 500
    # Device batches in flight at once: while one batch's results travel
    # host-ward, the next batches are already decoded and dispatched —
    # without this the device idles for a full transfer between batches.
    MAX_INFLIGHT = 4

    def __init__(self, engine, *, name: str = ""):
        self.engine = engine
        self.name = name
        self.queue: asyncio.Queue = asyncio.Queue()
        self._carry: list = []     # requests deferred by bucket-aware trim
        self._task: Optional[asyncio.Task] = None
        self._fetches: set = set()
        self.batches = 0
        self.frames = 0
        # Dispatched-batch size histogram {real_frames_in_batch: count}
        # — the saturation study's evidence for how well supply fills
        # buckets at each concurrency (VERDICT r3 #5).
        self.batch_hist: Dict[int, int] = {}
        # Ingest observability (per service): frames served via each path
        # and why the fast path was skipped. The fast paths silently
        # degrading to pixel decode must be visible in logs and counters.
        self.ingest: Dict[str, int] = {"sparse": 0, "planes": 0, "pixels": 0}
        self.fallbacks = 0
        self._fallback_logged = False

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._worker())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in list(self._fetches):
            t.cancel()
        # requests still queued (or deferred by the bucket trim) would
        # otherwise hang their awaiting submitters forever
        pending = list(self._carry)
        self._carry = []
        while True:
            try:
                pending.append(self.queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        for _, _, fut in pending:
            if not fut.done():
                fut.cancel()

    def submit_nowait(self, jpeg: bytes, threshold: float) -> asyncio.Future:
        """Enqueue one request; the returned future resolves with the
        frame's ALREADY-PACKED >BBhhhh wire record blob (bytes — see
        DetectionEngine.fetch_wire; DetectSession._respond just prepends
        the response header). Plain-future (no coroutine/Task) entry
        point so the per-datagram hot path costs one queue append, not
        a task spawn."""
        fut = asyncio.get_running_loop().create_future()
        self.queue.put_nowait((jpeg, threshold, fut))
        return fut

    async def submit(self, jpeg: bytes, threshold: float) -> bytes:
        return await self.submit_nowait(jpeg, threshold)

    async def _worker(self) -> None:
        import os

        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.MAX_INFLIGHT)
        # Optional batching window: after the first request of a batch,
        # wait up to this long for more to arrive before dispatching.
        # 0 (default) keeps the greedy behavior — zero added latency when
        # idle. On the JAX package's TPU deployment greedy batching beat a
        # window (fastdet_tpu/runtime/server.py); the card is not measured
        # yet. The knob exists for deployments with many more shallow
        # clients, where deeper batches may win back the wait.
        try:
            window_s = float(
                os.environ.get("FASTDET_BATCH_WINDOW_MS", "0")) / 1e3
        except ValueError:
            # an exception here would silently kill the worker task and
            # hang every request — bad config must not do that
            logger.warning(
                "FASTDET_BATCH_WINDOW_MS=%r is not a number; using 0",
                os.environ.get("FASTDET_BATCH_WINDOW_MS"))
            window_s = 0.0
        while True:
            if self._carry:
                # Requests deferred by the bucket trim below dispatch
                # first: under sustained load they ride the next (full)
                # batch; when traffic pauses they go out immediately.
                batch = self._carry
                self._carry = []
            else:
                batch = [await self.queue.get()]
            if window_s > 0.0:
                deadline = loop.time() + window_s
                while len(batch) < self.engine.max_batch:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self.queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
            while len(batch) < self.engine.max_batch:
                try:
                    batch.append(self.queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            # Bucket-aware trim: the engine pads every dispatch up to a
            # bucket, and the padded rows cross the host->device link. A
            # 10-frame batch in the 16-bucket ships 60% more bytes per real
            # frame than two bucket-fitting dispatches. Trim to the largest
            # bucket that fits and carry the newest remainder into the next
            # batch, but only when most of the batch survives (trimming
            # 3 -> 1 trades padding for a second fixed per-dispatch cost).
            buckets = getattr(self.engine, "buckets", None)
            if buckets:
                fit = max((b for b in buckets if b <= len(batch)), default=None)
                if fit is not None and len(batch) > fit > len(batch) // 2:
                    self._carry = batch[fit:]
                    batch = batch[:fit]
            # Bounded pipeline: block only when MAX_INFLIGHT batches are
            # already on the device; their results are fetched by
            # concurrent _finish tasks while we decode+dispatch the next.
            await sem.acquire()

            # Fast paths, fewest-bytes first: packed sparse coefficients
            # (host does only entropy decode; ~0.25-0.45 B/px), then
            # subsampled planes (host Huffman+IDCT; 1.5-2 B/px). Each is
            # all-or-nothing per batch (sparse internally reroutes
            # over-budget frames to planes and reports it in counts);
            # falls through to per-item pixel decode otherwise.
            t_try = time.perf_counter()
            futs_all = [it[2] for it in batch]
            res = None
            for path_name, dispatch in (
                ("sparse", self.engine.detect_async_sparse),
                ("planes", self.engine.detect_async_planes),
            ):
                try:
                    res = await loop.run_in_executor(
                        None, dispatch,
                        [it[0] for it in batch],
                        [it[1] for it in batch],
                    )
                except Exception:
                    logger.exception(
                        "%s ingest raised; trying next path (service=%s)",
                        path_name, self.name,
                    )
                    res = None
                if res is not None:
                    break
            if res is not None:
                STAGES.record("dispatch_batch",
                              time.perf_counter() - t_try)
                for k, v in (getattr(res, "counts", None)
                             or {"planes": len(batch)}).items():
                    self.ingest[k] = self.ingest.get(k, 0) + v
                unresolved = sorted(getattr(res, "unresolved", ()) or ())
                if not unresolved:
                    self._spawn_finish(res, futs_all, len(batch), t_try, sem)
                    continue
                # Partial dispatch: the decodable frames are already on
                # the device — finish them (None futs are skipped), and
                # run ONLY the undecodable frames down the host pixel
                # path below as their own dispatch (own inflight slot).
                uset = set(unresolved)
                self._spawn_finish(
                    res,
                    [f if i not in uset else None
                     for i, f in enumerate(futs_all)],
                    len(batch), t_try, sem)
                batch = [batch[i] for i in unresolved]
                await sem.acquire()
            else:
                self.fallbacks += 1
                if not self._fallback_logged:
                    self._fallback_logged = True
                    logger.info(
                        "plane ingest unavailable for this traffic; using "
                        "pixel decode (service=%s, batch=%d)",
                        self.name, len(batch),
                    )

            # Host JPEG decode on the executor (libjpeg releases the GIL).
            def _decode(item):
                jpeg_bytes, thr, _ = item
                from fastdet_tpu_torch.runtime import jpeg as jpeg_mod

                img = jpeg_mod.decode_rgb(jpeg_bytes)
                if img.shape[:2] != (self.engine.spec.image_size,) * 2:
                    raise ValueError("invalid image size")
                return img

            imgs, thrs, futs, failed = [], [], [], []
            t_dec = time.perf_counter()
            decoded = await asyncio.gather(
                *[loop.run_in_executor(None, _decode, it) for it in batch],
                return_exceptions=True,
            )
            STAGES.record("decode_batch", time.perf_counter() - t_dec)
            for (jpeg_bytes, thr, fut), img in zip(batch, decoded):
                if isinstance(img, BaseException):
                    failed.append((fut, img))
                else:
                    imgs.append(img)
                    thrs.append(thr)
                    futs.append(fut)
            for fut, err in failed:
                if not fut.done():
                    fut.set_exception(err if isinstance(err, Exception) else Exception(str(err)))

            if not imgs:
                sem.release()
                continue
            try:
                t_inf = time.perf_counter()
                res = self.engine.detect_async(imgs, thrs)
            except Exception as e:  # device-side failure: fail the batch
                sem.release()
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self.ingest["pixels"] += len(imgs)
            self._spawn_finish(res, futs, len(imgs), t_inf, sem)

    def _spawn_finish(self, res, futs, n, t0, sem) -> None:
        t = asyncio.get_running_loop().create_task(
            self._finish(res, futs, n, t0, sem))
        self._fetches.add(t)
        t.add_done_callback(self._fetches.discard)

    async def _finish(self, res, futs, n, t0, sem) -> None:
        """Fetch one in-flight batch's results and resolve its futures.
        Runs concurrently with the worker dispatching later batches."""
        loop = asyncio.get_running_loop()
        t_f = time.perf_counter()
        try:
            results = await loop.run_in_executor(
                None, self.engine.fetch_wire, res, n)
            STAGES.record("fetch_batch", time.perf_counter() - t_f)
        except Exception as e:
            for fut in futs:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            return
        finally:
            sem.release()
        t_done = time.perf_counter()
        STAGES.record("infer_batch", t_done - t0)
        self.batches += 1
        real = sum(1 for f in futs if f is not None)
        self.frames += real
        self.batch_hist[real] = self.batch_hist.get(real, 0) + 1
        self._maybe_log_stats()
        # A None fut marks a frame this dispatch does not cover (an
        # unresolved frame being retried down the pixel path).
        for fut, r in zip(futs, results):
            if fut is not None and not fut.done():
                fut.set_result(r)

    def _maybe_log_stats(self) -> None:
        if self.batches % self.STATS_EVERY:
            return
        logger.info(
            "service %s: batches=%d frames=%d avg_batch=%.2f ingest=%s "
            "fallbacks=%d infer[%s]",
            self.name, self.batches, self.frames,
            self.frames / max(self.batches, 1), self.ingest, self.fallbacks,
            STAGES.summary_line("infer_batch"),
        )


class DetectorService:
    """Adapter running a plain synchronous Detector (e.g. DummyDetector)."""

    def __init__(self, detector: Detector):
        self.detector = detector

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def submit_nowait(self, jpeg: bytes, threshold: float) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        try:
            fut.set_result(self.detector.perform(jpeg, threshold=threshold))
        except Exception as e:
            fut.set_exception(e)
        return fut

    async def submit(self, jpeg: bytes, threshold: float) -> List[ResultTuple]:
        return self.detector.perform(jpeg, threshold=threshold)


class DetectSession(asyncio.DatagramProtocol):
    """Per-FEED UDP endpoint: reassembly, detection, response streaming."""

    def __init__(self, service, peer: Tuple[str, int], session_id: bytes,
                 dbgout: Optional[str] = None):
        self.service = service
        self.peer = peer
        self.session_id = session_id
        self.dbgout = dbgout
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.reasm = wire.Reassembler()
        self.sender = wire.FrameSender(chunk_size=wire.SERVER_CHUNK_SIZE)
        self.last_seen = time.monotonic()
        self.closed = False
        # In-flight request futures, so close() can cancel them (the
        # batcher checks fut.done() before resolving, so a cancelled
        # request is simply skipped when its batch completes).
        self.pending: set = set()

    # -- DatagramProtocol hooks -----------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        # Stream initiation: 12-byte empty RTP packet (seqno -> 1).
        transport.sendto(self.sender.initiation_packet(), self.peer)
        logger.info(
            "init: rtp_host=%s, rtp_port=%s, session_id=%s",
            self.peer[0], self.peer[1], self.session_id.hex(),
        )

    def datagram_received(self, data: bytes, addr) -> None:
        if addr != self.peer:
            return  # reference drops foreign datagrams (server.py:207)
        self.last_seen = time.monotonic()
        before = self.reasm.drops
        for payload in self.reasm.feed(data):
            self._handle(payload)
        if self.reasm.drops != before:
            logger.info("recv: DROP (gap) session=%s", self.session_id.hex())

    # -- request handling ------------------------------------------------
    def _handle(self, payload: bytes) -> None:
        """Parse one request and enqueue it. Callback-based on purpose:
        a Task per request (coroutine + two extra loop wakeups) was a
        measurable fraction of the serving-vs-batched throughput gap on
        a single-core host, and this path runs for every frame."""
        req = wire.parse_request(payload)
        if req is None:
            return  # short/mismatched payloads silently dropped
        if self.dbgout:
            try:
                with open(self.dbgout, "wb") as fp:
                    fp.write(req.jpeg)
            except OSError:
                pass
        t0 = time.time()
        fut = self.service.submit_nowait(req.jpeg, req.threshold)
        self.pending.add(fut)
        fut.add_done_callback(
            lambda f, reqid=req.reqid, t0=t0: self._respond(reqid, t0, f))

    def _respond(self, reqid: int, t0: float, fut: asyncio.Future) -> None:
        self.pending.discard(fut)
        if fut.cancelled():
            return
        err = fut.exception()
        if err is None:
            results = fut.result()
        elif isinstance(err, ValueError):
            logger.error("request %d failed: %s", reqid, err)
            results = []
        else:
            logger.error("request %d failed", reqid, exc_info=err)
            results = []
        msec = int((time.time() - t0) * 1000)
        STAGES.record("request_e2e", time.time() - t0)
        if isinstance(results, (bytes, bytearray)):
            # ModelService futures carry pre-packed wire records
            # (engine.fetch_wire); plain Detector services carry tuples
            self.send_payload(wire.pack_response_raw(reqid, msec, results))
        else:
            resp = wire.DetectResponse(reqid=reqid, msec=msec,
                                       results=results)
            self.send_payload(resp.pack())

    def send_payload(self, payload: bytes) -> None:
        if self.transport is None or self.closed:
            return
        for frame in self.sender.frames(payload):
            self.transport.sendto(frame, self.peer)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            for fut in list(self.pending):
                fut.cancel()
            if self.transport is not None:
                self.transport.close()

    @property
    def udp_port(self) -> int:
        return self.transport.get_extra_info("sockname")[1]


class ControlConnection(asyncio.Protocol):
    """One TCP control connection (the reference's RTSPService)."""

    def __init__(self, server: "DetectionServer"):
        self.server = server
        self.transport: Optional[asyncio.Transport] = None
        self.buf = b""
        self.session: Optional[DetectSession] = None
        self.peer: Optional[Tuple[str, int]] = None
        self._closed = False
        # FEED handling awaits endpoint creation; pipelined FEED lines
        # must run their handlers SEQUENTIALLY or both observe
        # session=None, leak one endpoint, and interleave +OK replies
        # (asyncio.Lock wakes waiters FIFO, preserving line order)
        self._cmd_lock = asyncio.Lock()

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.peer = transport.get_extra_info("peername")
        self.server.connections.add(self)
        logger.info("accept: %s", self.peer)

    def data_received(self, data: bytes) -> None:
        # Line framing identical to the reference TCPService: split on \n,
        # carry partial lines across reads (server.py:64-85).
        self.buf += data
        while True:
            i = self.buf.find(b"\n")
            if i < 0:
                break
            line, self.buf = self.buf[: i + 1], self.buf[i + 1 :]
            self._feedline(line)

    def eof_received(self):
        if self.buf:
            self._feedline(self.buf)
            self.buf = b""
        return False

    def connection_lost(self, exc) -> None:
        logger.info("closed: %s", self.peer)
        self._closed = True
        self.server.connections.discard(self)
        if self.session is not None:
            self.server.drop_session(self.session)
            self.session = None

    def _feedline(self, line: bytes) -> None:
        cmd, args = wire.parse_command(line)
        if cmd == wire.CMD_FEED:
            asyncio.get_running_loop().create_task(self._startfeed(args))
        else:
            self.transport.write(wire.ERR_UNKNOWN)
            logger.error("unknown command: req=%r", line)

    async def _startfeed(self, args: bytes) -> None:
        async with self._cmd_lock:
            await self._startfeed_locked(args)

    async def _startfeed_locked(self, args: bytes) -> None:
        parsed = wire.parse_feed_args(args)
        service = None
        if parsed is not None:
            rtp_port, path = parsed
            service = self.server.services.get(path)
        if parsed is None or service is None:
            self.transport.write(wire.ERR_INVALID)
            logger.error("startfeed: invalid args: args=%r", args)
            return
        if self.session is not None:
            # Documented divergence: the reference overwrites its session
            # on a second FEED and leaks the first UDP endpoint until
            # process exit (server.py:311-314); we close the old session
            # — one control connection owns at most one data session.
            logger.info(
                "startfeed: closing previous session %s",
                self.session.session_id.hex(),
            )
            self.server.drop_session(self.session)
            self.session = None
        rtp_host = self.peer[0]
        session_id = bytes(random.randrange(256) for _ in range(4))
        session = DetectSession(
            service, (rtp_host, rtp_port), session_id, dbgout=self.server.dbgout
        )
        loop = asyncio.get_running_loop()
        # Size the socket for burst traffic: one 416px JPEG request is
        # ~100 KB across ~4 datagrams, and concurrent clients send their
        # whole in-flight window at once. Linux's default rcvbuf
        # (~212 KB) holds only ~2 requests, so a burst overflows it and
        # the kernel silently drops datagrams — which the gap-cancel
        # semantics then turn into whole lost frames (the wire protocol
        # has no retransmit, matching the reference). 4 MB absorbs ~40
        # in-flight requests per session; the kernel caps the value at
        # net.core.rmem_max, so this is best-effort by design.
        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
        for opt in (socket_mod.SO_RCVBUF, socket_mod.SO_SNDBUF):
            try:
                sock.setsockopt(socket_mod.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass
        sock.setblocking(False)
        sock.bind(("0.0.0.0", 0))
        await loop.create_datagram_endpoint(lambda: session, sock=sock)
        if self._closed:
            # the TCP connection died while the endpoint was being
            # created: connection_lost already ran (session was None
            # then), so nothing will ever drop this session — close it
            # now instead of pinning a buffered UDP socket on the reaper
            session.close()
            return
        self.session = session
        self.server.sessions.append(session)
        port = session.udp_port
        logger.info(
            "startfeed: port=%s, rtp_host=%s, rtp_port=%s, session_id=%s, path=%s",
            port, rtp_host, rtp_port, session_id.hex(), path,
        )
        self.transport.write(wire.pack_ok(port, session_id))


class DetectionServer:
    """Multi-model detection server (the reference's RTSPServer + loop)."""

    def __init__(
        self,
        services: Dict[str, object],   # path -> ModelService | DetectorService
        port: int = 10000,
        host: str = "0.0.0.0",
        dbgout: Optional[str] = None,
    ):
        self.services = services
        self.port = port
        self.host = host
        self.dbgout = dbgout
        self.sessions: List[DetectSession] = []
        self.connections: set = set()          # live ControlConnections
        self._tcp_server: Optional[asyncio.AbstractServer] = None
        self.bound_port: Optional[int] = None  # set once listening (port=0 ok)

    def request_shutdown(self) -> None:
        """Abort live control connections and stop listening.

        MUST run before cancelling the serve task: py3.12's
        Server.serve_forever() awaits wait_closed() on cancellation, which
        blocks until every open connection handler finishes — so a client
        holding its control TCP open would keep the server (and its UDP
        sessions) alive forever.
        """
        for conn in list(self.connections):
            if conn.transport is not None:
                conn.transport.abort()
        if self._tcp_server is not None:
            self._tcp_server.close()

    def drop_session(self, session: DetectSession) -> None:
        session.close()
        if session in self.sessions:
            self.sessions.remove(session)

    async def _reaper(self) -> None:
        # Enforced session idle timeout (reference declares but never uses
        # one, server.py:184,190).
        while True:
            await asyncio.sleep(SESSION_IDLE_TIMEOUT / 4)
            now = time.monotonic()
            for s in list(self.sessions):
                if now - s.last_seen > SESSION_IDLE_TIMEOUT:
                    logger.info("session idle timeout: %s", s.session_id.hex())
                    self.drop_session(s)

    async def serve(self, ready: Optional[asyncio.Event] = None) -> None:
        loop = asyncio.get_running_loop()
        for svc in self.services.values():
            svc.start()
        self._tcp_server = await loop.create_server(
            lambda: ControlConnection(self), self.host, self.port
        )
        self.bound_port = self._tcp_server.sockets[0].getsockname()[1]
        logger.info("listening: port=%s...", self.bound_port)
        reaper = loop.create_task(self._reaper())
        if ready is not None:
            ready.set()
        try:
            await self._tcp_server.serve_forever()
        finally:
            reaper.cancel()
            self.request_shutdown()
            for svc in self.services.values():
                svc.stop()
            for s in list(self.sessions):
                self.drop_session(s)

    def run(self) -> None:
        asyncio.run(self.serve())


def build_services(
    registry_args: List[str],
    *,
    mode: Optional[str] = None,
    dbgout: Optional[str] = None,
    warmup: bool = True,
    device: str = "cuda",
    devices=None,
    buckets: Optional[Tuple[int, ...]] = None,
    calibration_images=None,
) -> Dict[str, object]:
    """Build {path: service} from reference-style ``name:num_classes:path``
    registry arguments (server.py:354-358); empty -> {'detect': dummy}
    (server.py:359-360). ``path`` is any weights.load_model form (.npz,
    darknet .weights cached as .weights.npz, .onnx, synthetic[:arch]).
    Engines run on ``device`` and ``devices`` as DetectionEngine takes
    them (every visible card unless the caller asks otherwise; the
    batcher fills each engine's max_batch), with the engine's default
    batch buckets unless ``buckets`` is given; ``mode="int8"`` engines calibrate on
    ``calibration_images`` ((N, H, W, 3) uint8) when given.
    """
    services: Dict[str, object] = {}
    if not registry_args:
        services["detect"] = DetectorService(DummyDetector(dbgout=dbgout))
        return services
    from fastdet_tpu_torch.parallel.checkpoint import cached_import
    from fastdet_tpu_torch.runtime.engine import DetectionEngine

    for arg in registry_args:
        (name, num_classes, path) = arg.split(":", 2)
        spec, params = cached_import(path, num_classes=int(num_classes))
        kw = {} if buckets is None else {"buckets": buckets}
        engine = DetectionEngine(spec, params, mode=mode, device=device,
                                 devices=devices,
                                 calibration_images=calibration_images,
                                 **kw)
        if warmup:
            engine.warmup()
        services[name] = ModelService(engine, name=name)
    return services
