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
from fastdet_tpu_torch.utils import profiling
from fastdet_tpu_torch.utils.profiling import GLOBAL as STAGES
from fastdet_tpu_torch.utils.profiling import now_ns
from fastdet_tpu_torch.wire.messages import ResultTuple

logger = logging.getLogger(__name__)

SESSION_IDLE_TIMEOUT = 60.0   # seconds without datagrams before teardown


class Request:
    """One frame's request in a service: the frame, the future its
    answer resolves, its id, ``bid``, the batch that answered it, and the
    ``perf_counter_ns`` stamps its spans share: ``t0`` (parsed and
    queued), ``t_form`` (its batch formed), ``t_slot`` (the batch's
    in-flight slot held) and ``t_done`` (the batch's results on the
    host)."""

    __slots__ = ("jpeg", "threshold", "fut", "rid", "t0", "bid", "t_form",
                 "t_slot", "t_done")

    def __init__(self, jpeg: bytes, threshold: float, fut: asyncio.Future,
                 t0: int):
        self.jpeg = jpeg
        self.threshold = threshold
        self.fut = fut
        self.rid = profiling.new_id()
        self.t0 = t0
        self.bid: Optional[int] = None
        self.t_form: Optional[int] = None
        self.t_slot: Optional[int] = None
        self.t_done: Optional[int] = None


class ModelService:
    """Continuous batcher in front of one DetectionEngine.

    submit() resolves when the request's results are ready. The worker
    collects every queued request (up to the engine's largest bucket) the
    moment the engine is free — batch size adapts to load automatically.
    """

    # Emit the counters and the mean of each term of a request's time
    # in the server to the log every this many batches.
    STATS_EVERY = 500
    #: the log line's labels of the terms a request's ``request_e2e``
    #: splits into, in order: the spans ``service.queue_wait``,
    #: ``service.pipeline_wait``, ``infer_batch``, ``session.respond``
    PARTITION = ("queue", "pipeline", "infer", "respond")
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
        # The log line's request-weighted sums: ns of each PARTITION term
        # and of request_e2e over the requests answered
        self.answered = 0
        self._term_ns = [0] * (len(self.PARTITION) + 1)

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
        for req in pending:
            if not req.fut.done():
                req.fut.cancel()

    def submit_request(self, jpeg: bytes, threshold: float,
                       t0: int) -> Request:
        """Enqueue one request parsed at ``t0`` (``perf_counter_ns``);
        its future resolves with the frame's ALREADY-PACKED >BBhhhh wire
        record blob (bytes — see DetectionEngine.fetch_wire;
        DetectSession._respond just prepends the response header).
        Plain-future (no coroutine/Task) entry point so the
        per-datagram hot path costs one queue append, not a task
        spawn."""
        req = Request(jpeg, threshold,
                      asyncio.get_running_loop().create_future(), t0)
        self.queue.put_nowait(req)
        return req

    def submit_nowait(self, jpeg: bytes, threshold: float) -> asyncio.Future:
        """:meth:`submit_request` from now; returns the future."""
        return self.submit_request(jpeg, threshold, now_ns()).fut

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
            bid, t_form = profiling.new_id(), now_ns()
            # Bounded pipeline: block only when MAX_INFLIGHT batches are
            # already on the device; their results are fetched by
            # concurrent _finish tasks while we decode+dispatch the next.
            await sem.acquire()
            t_slot = now_ns()
            STAGES.record("service.pipeline_wait", t_form, t_slot, bid=bid)

            # Fast paths, fewest-bytes first: packed sparse coefficients
            # (host does only entropy decode; ~0.25-0.45 B/px), then
            # subsampled planes (host Huffman+IDCT; 1.5-2 B/px). Each is
            # all-or-nothing per batch (sparse internally reroutes
            # over-budget frames to planes and reports it in counts);
            # falls through to per-item pixel decode otherwise.
            res = None
            for path_name, dispatch in (
                ("sparse", self.engine.detect_async_sparse),
                ("planes", self.engine.detect_async_planes),
            ):
                try:
                    res = await loop.run_in_executor(
                        None, profiling.call_in_batch, bid, dispatch,
                        [it.jpeg for it in batch],
                        [it.threshold for it in batch],
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
                t_disp = now_ns()
                STAGES.record("dispatch_batch", t_slot, t_disp, bid=bid)
                for k, v in (getattr(res, "counts", None)
                             or {"planes": len(batch)}).items():
                    self.ingest[k] = self.ingest.get(k, 0) + v
                unresolved = sorted(getattr(res, "unresolved", ()) or ())
                if not unresolved:
                    self._spawn_finish(res, batch, bid, t_form, t_slot, sem)
                    continue
                # Partial dispatch: the decodable frames are already on
                # the device — finish them (None entries are skipped),
                # and run ONLY the undecodable frames down the host pixel
                # path below as a batch of their own (own inflight slot),
                # formed when the dispatch returned.
                uset = set(unresolved)
                self._spawn_finish(
                    res, [r if i not in uset else None
                          for i, r in enumerate(batch)],
                    bid, t_form, t_slot, sem)
                batch = [batch[i] for i in unresolved]
                bid, t_form = profiling.new_id(), t_disp
                await sem.acquire()
                t_slot = now_ns()
                STAGES.record("service.pipeline_wait", t_form, t_slot,
                              bid=bid)
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
            def _decode(req):
                from fastdet_tpu_torch.runtime import jpeg as jpeg_mod

                img = jpeg_mod.decode_rgb(req.jpeg)
                if img.shape[:2] != (self.engine.spec.image_size,) * 2:
                    raise ValueError("invalid image size")
                return img

            decoded = await asyncio.gather(
                *[loop.run_in_executor(None, _decode, it) for it in batch],
                return_exceptions=True,
            )
            imgs, reqs = [], []
            for req, img in zip(batch, decoded):
                if isinstance(img, BaseException):
                    if not req.fut.done():
                        req.fut.set_exception(
                            img if isinstance(img, Exception)
                            else Exception(str(img)))
                else:
                    imgs.append(img)
                    reqs.append(req)

            if not imgs:
                sem.release()
                continue
            try:
                res = profiling.call_in_batch(
                    bid, self.engine.detect_async, imgs,
                    [it.threshold for it in reqs])
            except Exception as e:  # device-side failure: fail the batch
                sem.release()
                for req in reqs:
                    if not req.fut.done():
                        req.fut.set_exception(e)
                continue
            self.ingest["pixels"] += len(imgs)
            self._spawn_finish(res, reqs, bid, t_form, t_slot, sem)

    def _spawn_finish(self, res, reqs, bid, t_form, t_slot, sem) -> None:
        """Batch ``bid`` (formed at ``t_form``, its slot held from
        ``t_slot``) is on the device: its requests' queue waits end, and
        a task fetches its results. A None entry of ``reqs`` is a row
        this dispatch does not answer."""
        for req in reqs:
            if req is not None:
                req.bid, req.t_form, req.t_slot = bid, t_form, t_slot
                STAGES.record("service.queue_wait", req.t0, t_form,
                              rid=req.rid, bid=bid)
        t = asyncio.get_running_loop().create_task(
            self._finish(res, reqs, bid, t_slot, sem))
        self._fetches.add(t)
        t.add_done_callback(self._fetches.discard)

    async def _finish(self, res, reqs, bid, t_slot, sem) -> None:
        """Fetch one in-flight batch's results and resolve its futures.
        Runs concurrently with the worker dispatching later batches."""
        loop = asyncio.get_running_loop()
        t_f = now_ns()
        try:
            results = await loop.run_in_executor(
                None, self.engine.fetch_wire, res, len(reqs))
        except Exception as e:
            for req in reqs:
                if req is not None and not req.fut.done():
                    req.fut.set_exception(e)
            return
        finally:
            sem.release()
        t_done = now_ns()
        STAGES.record("fetch_batch", t_f, t_done, bid=bid)
        STAGES.record("infer_batch", t_slot, t_done, bid=bid)
        self.batches += 1
        real = sum(1 for r in reqs if r is not None)
        self.frames += real
        self.batch_hist[real] = self.batch_hist.get(real, 0) + 1
        self._maybe_log_stats()
        for req, r in zip(reqs, results):
            if req is not None and not req.fut.done():
                req.t_done = t_done
                req.fut.set_result(r)

    def account(self, req: Request, t_ans: int) -> None:
        """Add request ``req``, answered at ``t_ans``, to the log line's
        means: its PARTITION terms, which sum to its request_e2e."""
        self.answered += 1
        stamps = (req.t0, req.t_form, req.t_slot, req.t_done, t_ans)
        for i in range(len(stamps) - 1):
            self._term_ns[i] += stamps[i + 1] - stamps[i]
        self._term_ns[-1] += t_ans - req.t0

    def _maybe_log_stats(self) -> None:
        if self.batches % self.STATS_EVERY:
            return
        means = [ns / max(self.answered, 1) / 1e6 for ns in self._term_ns]
        logger.info(
            "service %s: batches=%d frames=%d avg_batch=%.2f ingest=%s "
            "fallbacks=%d request mean ms over %d answered: %s = %.2f "
            "(request_e2e)",
            self.name, self.batches, self.frames,
            self.frames / max(self.batches, 1), self.ingest, self.fallbacks,
            self.answered,
            " + ".join(f"{label} {v:.2f}" for label, v
                       in zip(self.PARTITION, means)),
            means[-1],
        )


class DetectorService:
    """Adapter running a plain synchronous Detector (e.g. DummyDetector)."""

    def __init__(self, detector: Detector):
        self.detector = detector

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def submit_request(self, jpeg: bytes, threshold: float,
                       t0: int) -> Request:
        req = Request(jpeg, threshold,
                      asyncio.get_running_loop().create_future(), t0)
        try:
            req.fut.set_result(self.detector.perform(jpeg,
                                                     threshold=threshold))
        except Exception as e:
            req.fut.set_exception(e)
        return req

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
        # perf_counter_ns of the first datagram of the payload being
        # reassembled (None between payloads)
        self._t_first: Optional[int] = None

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
        if self._t_first is None:
            self._t_first = now_ns()
        before = self.reasm.drops
        for payload in self.reasm.feed(data):
            t_done = now_ns()
            rid = self._handle(payload, t_done)
            STAGES.record("session.reassembly", self._t_first, t_done,
                          rid=rid)
        if self.reasm.idle:
            self._t_first = None
        if self.reasm.drops != before:
            logger.info("recv: DROP (gap) session=%s", self.session_id.hex())

    # -- request handling ------------------------------------------------
    def _handle(self, payload: bytes, t0: int) -> Optional[int]:
        """Parse one request completed at ``t0`` (``perf_counter_ns``)
        and enqueue it; returns its request id (None when the payload is
        no request). Callback-based on purpose: a Task per request
        (coroutine + two extra loop wakeups) was a measurable fraction
        of the serving-vs-batched throughput gap on a single-core host,
        and this path runs for every frame."""
        msg = wire.parse_request(payload)
        if msg is None:
            return None  # short/mismatched payloads silently dropped
        if self.dbgout:
            try:
                with open(self.dbgout, "wb") as fp:
                    fp.write(msg.jpeg)
            except OSError:
                pass
        req = self.service.submit_request(msg.jpeg, msg.threshold, t0)
        self.pending.add(req.fut)
        req.fut.add_done_callback(
            lambda f, reqid=msg.reqid, req=req: self._respond(reqid, req))
        return req.rid

    def _respond(self, reqid: int, req: Request) -> None:
        """Answer one request. ``msec`` and the spans ``request_e2e``
        and ``session.respond`` end at one stamp, taken as the answer's
        header is packed."""
        fut = req.fut
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
        t_ans = now_ns()
        msec = (t_ans - req.t0) // 1_000_000
        STAGES.record("request_e2e", req.t0, t_ans, rid=req.rid, bid=req.bid)
        if req.t_done is not None:
            STAGES.record("session.respond", req.t_done, t_ans, rid=req.rid,
                          bid=req.bid)
            self.service.account(req, t_ans)
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
