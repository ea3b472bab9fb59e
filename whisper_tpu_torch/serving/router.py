"""Data-parallel request router: the serving front end of a fleet of
engines.

Port of ``whisper_tpu/serving/router.py``. One continuous-batching engine
per data replica (a ``python -m whisper_tpu_torch.serving`` worker, pinned
to its own cards), so the token loop carries no traffic between replicas,
and this router in front, speaking the server's wire protocols (``/asr``
multipart and octet-stream, ``/health``, ``/metrics``). It is host code
over HTTP: no tensor passes through it.

Routing policy: least-in-flight among healthy backends, round-robin among
ties. A backend that fails to connect is skipped for ``cooldown_s`` and the
request retries on the next one; a backend answering 503 (its engine's
queue is full) is skipped for this request only. A slow or dead replica
costs capacity, not availability.

Long audio: with more than one backend, the router splits a request over
30 s into overlapping 30 s windows, fans them out over the fleet in
parallel and merges the transcripts (``longform.merge_transcripts``). A
streamed long request fans out too: the windows' partials are relayed in
window order, each merged with the finished transcripts of the windows
before it, and the merged reply closes the NDJSON stream.
"""

from __future__ import annotations

import http.client
import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

HOP_HEADERS = {
    "connection", "keep-alive", "transfer-encoding", "te", "trailer",
    "upgrade", "proxy-authenticate", "proxy-authorization", "host",
    "content-length", "server", "date",
}


@dataclass
class Backend:
    """One data-parallel replica (an engine + server, on its own cards)."""

    url: str  # http://host:port
    in_flight: int = 0
    requests_total: int = 0
    errors_total: int = 0
    busy_total: int = 0  # 503 backpressure replies (busy, not dead)
    down_until: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def hostport(self) -> Tuple[str, int]:
        u = urlsplit(self.url if "//" in self.url else f"http://{self.url}")
        return u.hostname or "127.0.0.1", u.port or 80

    def healthy(self) -> bool:
        return time.monotonic() >= self.down_until


class Router:
    """Thread-safe backend pool with least-in-flight selection."""

    def __init__(self, backend_urls: List[str], cooldown_s: float = 2.0,
                 connect_timeout_s: float = 10.0, split_longform: bool = True,
                 longform_overlap_s: float = 2.0):
        assert backend_urls, "router needs at least one backend"
        self.backends = [Backend(url=u) for u in backend_urls]
        self.cooldown_s = cooldown_s
        self.connect_timeout_s = connect_timeout_s
        self.split_longform = split_longform
        self.longform_overlap_s = longform_overlap_s
        self.split_requests_total = 0
        self._rr = itertools.count()
        self._lock = threading.Lock()

    def pick(self, exclude: Optional[set] = None) -> Optional[Backend]:
        """Least-in-flight healthy backend; round-robin among ties."""
        exclude = exclude or set()
        with self._lock:
            up = [b for b in self.backends
                  if b.healthy() and id(b) not in exclude]
            if not up:
                return None
            lo = min(b.in_flight for b in up)
            tied = [b for b in up if b.in_flight == lo]
            return tied[next(self._rr) % len(tied)]

    def mark_down(self, b: Backend):
        b.down_until = time.monotonic() + self.cooldown_s
        b.errors_total += 1

    # ---------------------------------------------------------------- proxy
    def forward(self, method: str, path: str, body: Optional[bytes],
                headers: dict, read_timeout_s: float = 600.0):
        """Try backends (each at most once) until one accepts the request.

        Returns (backend, HTTPResponse, connection) — caller must call
        ``release``. Raises ConnectionError when every backend is down/full.
        """
        tried: set = set()
        any_busy = False
        while True:
            b = self.pick(exclude=tried)
            if b is None:
                raise ConnectionError(
                    "all backends busy (503 backpressure)" if any_busy
                    else "no healthy backend available")
            tried.add(id(b))
            host, port = b.hostport
            with b.lock:
                b.in_flight += 1
            conn = http.client.HTTPConnection(
                host, port, timeout=read_timeout_s)
            try:
                conn.putrequest(method, path, skip_host=True,
                                skip_accept_encoding=True)
                conn.putheader("Host", f"{host}:{port}")
                for k, v in headers.items():
                    if k.lower() not in HOP_HEADERS:
                        conn.putheader(k, v)
                if body is not None:
                    conn.putheader("Content-Length", str(len(body)))
                conn.endheaders()
                if body:
                    conn.send(body)
                resp = conn.getresponse()
            except OSError:
                self.release(b, conn, error=True)
                continue
            if resp.status == 503:  # engine backpressure: spill to the next
                # busy != dead: no cooldown/mark_down, or uniform saturation
                # would report 'no healthy backend' for cooldown_s instead of
                # busy. `tried` already skips it this request.
                resp.read()
                b.busy_total += 1
                any_busy = True
                self.release(b, conn)
                continue
            b.requests_total += 1
            return b, resp, conn

    def release(self, b: Backend, conn, error: bool = False):
        with b.lock:
            b.in_flight = max(0, b.in_flight - 1)
        if error:
            self.mark_down(b)
        try:
            conn.close()
        except OSError:
            pass

    # ---------------------------------------------------------------- fleet
    def _get_json(self, b: Backend, path: str, timeout_s: float = 5.0):
        host, port = b.hostport
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode() or "{}")
        finally:
            conn.close()

    def health(self) -> dict:
        per = []
        up = 0
        for b in self.backends:
            try:
                status, _ = self._get_json(b, "/health")
                ok = status == 200
            except OSError:
                ok = False
            up += ok
            per.append({"url": b.url, "healthy": ok})
        return {
            "status": "healthy" if up == len(per) else
            ("degraded" if up else "unhealthy"),
            "backends": per,
        }

    def metrics(self) -> dict:
        per = []
        totals = {"requests_total": 0, "tokens_total": 0,
                  "audio_seconds_total": 0.0, "queue_depth": 0,
                  "active_slots": 0}
        for b in self.backends:
            row = {"url": b.url, "router_requests": b.requests_total,
                   "router_errors": b.errors_total,
                   "router_busy": b.busy_total,
                   "in_flight": b.in_flight}
            try:
                _, m = self._get_json(b, "/metrics")
                row.update(m)
                for k in totals:
                    totals[k] += m.get(k, 0)
            except OSError:
                row["unreachable"] = True
            per.append(row)
        out = dict(totals)
        out["router_split_requests"] = self.split_requests_total
        out["backends"] = per
        return out


def _parse_asr_request(body: bytes, ctype: str, headers, qs: dict):
    """Best-effort decode of an /asr POST into (mono f32 audio, params).

    Understands the same three encodings as the server (multipart WAV,
    octet-stream f32 PCM, bare WAV body). Returns None when the body can't
    be parsed — the request is then relayed untouched and the backend
    produces the authoritative error.
    """
    from ..ops.audio import WavFormatError, load_audio, pcm_f32_from_bytes

    params = {"language": qs.get("language", "zh"),
              "task": qs.get("task", "transcribe"),
              "beam": qs.get("beam", "1"),
              "temperature": qs.get("temperature", "0"),
              "word_timestamps": qs.get("word_timestamps", "0"),
              "initial_prompt": qs.get("initial_prompt", ""),
              "condition_on_previous": qs.get("condition_on_previous", "0"),
              "format": qs.get("format", "json")}
    try:
        if ctype.startswith("multipart/form-data"):
            from .wire import parse_multipart

            fields = parse_multipart(body, ctype)
            if "wav" not in fields:
                return None
            audio = load_audio(fields["wav"])
            for k in params:
                v = fields.get(k)
                if v:
                    params[k] = v
        elif ctype.startswith("application/octet-stream"):
            if len(body) % 4 != 0:
                return None
            audio = pcm_f32_from_bytes(body)
            for k, h in (("language", "X-Language"), ("task", "X-Task"),
                         ("beam", "X-Beam"), ("temperature", "X-Temperature"),
                         ("word_timestamps", "X-Word-Timestamps"),
                         ("initial_prompt", "X-Initial-Prompt"),
                         ("condition_on_previous",
                          "X-Condition-On-Previous"),
                         ("format", "X-Format")):
                v = headers.get(h)
                if v:
                    if k == "initial_prompt":
                        # header values arrive latin-1 (HTTP); recover the
                        # utf-8 prompt NOW so params holds the true text —
                        # hdrs_for/_stream_window re-encode for the wire,
                        # and skipping this step double-encoded non-ASCII
                        # (zh) prompts on the fleet split path
                        try:
                            v = v.encode("latin-1").decode("utf-8")
                        except (UnicodeDecodeError, UnicodeEncodeError):
                            pass
                    params[k] = v
        else:
            audio = load_audio(body)
    except (WavFormatError, ValueError):
        return None
    return audio, params


class RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router = None  # bound by make_router

    def log_message(self, fmt, *args):
        pass

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload, ensure_ascii=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            h = self.router.health()
            self._send(200 if h["status"] == "healthy" else 503, h)
        elif self.path == "/metrics":
            self._send(200, self.router.metrics())
        else:
            self._send(404, {"success": False, "error": "not found"})

    def do_OPTIONS(self):
        self._send(200, {})

    def _maybe_split_longform(self, body: bytes, qs: dict) -> bool:
        """Handle a >30 s request by fanning windows across the fleet.

        Returns True when the request was fully answered here. One engine
        decodes a long request's windows as concurrent slot streams; the
        router spreads them over every replica.
        """
        from ..config import N_SAMPLES, SAMPLE_RATE

        parsed = _parse_asr_request(
            body, self.headers.get("Content-Type", ""), self.headers, qs)
        if parsed is None:
            return False
        audio, params = parsed
        if str(params.get("condition_on_previous", "0")).lower() in (
                "1", "true", "yes", "on"):
            # conditioning chains windows sequentially — relay the whole
            # request to ONE backend whose engine runs the conditioned
            # longform path; a fleet split would break the context chain
            return False
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.size <= N_SAMPLES:
            return False

        from ..formats import HTTP_CONTENT_TYPES
        fmt = str(params.get("format") or "json").lower()
        if fmt not in HTTP_CONTENT_TYPES:
            self._send(400, {"success": False,
                             "error": f"bad format {fmt!r}; known: "
                                      f"{sorted(HTTP_CONTENT_TYPES)}"})
            return True
        if fmt in ("srt", "vtt", "tsv"):
            # subtitle segments come from word timings: force them on the
            # windows so the merged payload can be rendered here
            params["word_timestamps"] = "1"

        from ..longform import merge_transcripts, split_audio

        router = self.router
        overlap = int(router.longform_overlap_s * SAMPLE_RATE)
        waves, _ = split_audio(audio, N_SAMPLES, overlap)
        t0 = time.perf_counter()

        def hdrs_for(language, window: int = 1) -> dict:
            h = {"Content-Type": "application/octet-stream",
                 "X-Language": str(language),
                 "X-Task": str(params["task"]),
                 "X-Beam": str(params["beam"]),
                 "X-Temperature": str(params["temperature"]),
                 "X-Word-Timestamps": str(params["word_timestamps"])}
            ip = params.get("initial_prompt")
            if ip and window == 0:
                # the user prompt seeds window 0 only (engine semantics)
                h["X-Initial-Prompt"] = (
                    str(ip).encode("utf-8").decode("latin-1"))
            return h

        def one(w: np.ndarray, language, window: int = 1) -> dict:
            b, resp, conn = router.forward("POST", "/asr", w.tobytes(),
                                           hdrs_for(language, window))
            try:
                payload = json.loads(resp.read().decode() or "{}")
            finally:
                router.release(b, conn)
            if resp.status != 200 or not payload.get("success", False):
                raise RuntimeError(str(payload.get("error")
                                       or f"backend HTTP {resp.status}"))
            return payload

        lang = params["language"]
        if lang in (None, "", "auto"):
            # resolve auto-detection on the FIRST window and forward the
            # code to the rest — independent per-window detection can decode
            # one utterance's windows in different languages
            first = one(waves[0], "auto", window=0)
            lang = first.get("language") or "en"
            if lang in ("", "auto"):
                lang = "en"
            with ThreadPoolExecutor(max_workers=min(len(waves), 16)) as ex:
                rest = list(ex.map(lambda w: one(w, lang), waves[1:]))
            results = [first] + rest
        else:
            with ThreadPoolExecutor(max_workers=min(len(waves), 16)) as ex:
                results = list(ex.map(
                    lambda iw: one(iw[1], lang, window=iw[0]),
                    enumerate(waves)))
        with router._lock:  # handler threads are concurrent
            router.split_requests_total += 1

        step = (N_SAMPLES - overlap) / SAMPLE_RATE
        merged = merge_transcripts(results, step, overlap / SAMPLE_RATE, lang)
        wall = time.perf_counter() - t0
        audio_s = audio.size / SAMPLE_RATE
        out = {
            "success": True,
            "text": merged["text"],
            "language": lang,
            "audio_seconds": audio_s,
            "wall_seconds": wall,
            "rtf": wall / max(audio_s, 1e-9),
            "windows": len(waves),
            "split": "router",
            "tokens": int(sum(r.get("tokens", 0) for r in results)),
        }
        lps = [r["avg_logprob"] for r in results if "avg_logprob" in r]
        if lps:
            out["avg_logprob"] = float(sum(lps) / len(lps))
        nsp = [r["no_speech_prob"] for r in results if "no_speech_prob" in r]
        if nsp:
            out["no_speech_prob"] = float(max(nsp))
        crs = [r["compression_ratio"] for r in results
               if "compression_ratio" in r]
        if crs:
            out["compression_ratio"] = float(max(crs))
        if all("quality_ok" in r for r in results):
            out["quality_ok"] = all(r["quality_ok"] for r in results)
        if str(params["word_timestamps"]).lower() in ("1", "true", "yes",
                                                      "on"):
            out["words"] = merged.get("words", [])
        if fmt != "json":
            from ..formats import render_payload

            self._send_text(200, render_payload(out, fmt),
                            HTTP_CONTENT_TYPES[fmt])
        else:
            self._send(200, out)
        return True

    # ---------------------------------------------------- streaming split
    def _chunk(self, obj: dict):
        data = (json.dumps(obj, ensure_ascii=False) + "\n").encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _stream_window(self, w: np.ndarray, language, out_q,
                       window: int = 1):
        """POST one window with stream=1 and feed its NDJSON lines into
        out_q as ("partial", text) / ("final", payload) / ("error", msg)."""
        router = self.router
        hdrs = {"Content-Type": "application/octet-stream",
                "X-Language": str(language), "X-Stream": "1"}
        for k, h in (("task", "X-Task"), ("beam", "X-Beam"),
                     ("temperature", "X-Temperature"),
                     ("word_timestamps", "X-Word-Timestamps")):
            hdrs[h] = str(self._split_params[k])
        ip = self._split_params.get("initial_prompt")
        if ip and window == 0:  # user prompt seeds window 0 only
            hdrs["X-Initial-Prompt"] = (
                str(ip).encode("utf-8").decode("latin-1"))
        try:
            b, resp, conn = router.forward("POST", "/asr", w.tobytes(), hdrs)
        except ConnectionError as e:
            out_q.put(("error", str(e)))
            return
        try:
            while True:
                line = resp.readline()
                if not line:
                    out_q.put(("error", "backend stream ended early"))
                    return
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if "partial" in obj:
                    out_q.put(("partial", obj["partial"]))
                else:
                    if not obj.get("success", False):
                        out_q.put(("error", str(obj.get("error")
                                               or "window failed")))
                    else:
                        out_q.put(("final", obj))
                    return
        except OSError as e:
            out_q.put(("error", str(e)))
        finally:
            router.release(b, conn)

    def _maybe_stream_split_longform(self, body: bytes, qs: dict) -> bool:
        """Streaming counterpart of the router split: windows decode
        fleet-parallel with stream=1; their partials are relayed IN WINDOW
        ORDER, each merged with the finished transcripts of earlier
        windows, then the merged final payload closes the stream."""
        import queue as _q

        from ..config import N_SAMPLES, SAMPLE_RATE
        from ..longform import merge_texts, merge_transcripts, split_audio

        parsed = _parse_asr_request(
            body, self.headers.get("Content-Type", ""), self.headers, qs)
        if parsed is None:
            return False
        audio, params = parsed
        if str(params.get("condition_on_previous", "0")).lower() in (
                "1", "true", "yes", "on"):
            return False  # sequential conditioning: one backend handles it
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.size <= N_SAMPLES:
            return False
        if str(params.get("format") or "json").lower() != "json":
            # same contract as the server: streaming is NDJSON-only
            self._send(400, {"success": False,
                             "error": "format is not supported with "
                                      "streaming (NDJSON only)"})
            return True
        self._split_params = params
        router = self.router
        overlap = int(router.longform_overlap_s * SAMPLE_RATE)
        waves, _ = split_audio(audio, N_SAMPLES, overlap)
        n = len(waves)
        t0 = time.perf_counter()

        self.send_response(200)
        self.send_header("Content-Type",
                         "application/x-ndjson; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()

        lang = params["language"]
        queues = [_q.Queue() for _ in range(n)]
        threads = []

        def launch(j, language):
            t = threading.Thread(target=self._stream_window,
                                 args=(waves[j], language, queues[j], j),
                                 daemon=True)
            t.start()
            threads.append(t)

        try:
            auto = lang in (None, "", "auto")
            launch(0, "auto" if auto else lang)
            if not auto:
                # language is explicit: no detection hand-off needed, so
                # every window decodes fleet-parallel from the start (only
                # the partial-relay ORDER stays sequential) — matching the
                # non-streaming split's parallelism
                for k in range(1, n):
                    launch(k, lang)
            finals: List[Optional[dict]] = [None] * n
            for j in range(n):
                while True:
                    kind, payload = queues[j].get()
                    if kind == "error":
                        self._chunk({"success": False, "error": payload,
                                     "window": j})
                        self.wfile.write(b"0\r\n\r\n")
                        return True
                    if kind == "partial":
                        prefix = [finals[i]["text"] for i in range(j)]
                        self._chunk({"partial": merge_texts(
                            prefix + [payload],
                            lang if not auto else "en"),
                            "window": j})
                        continue
                    finals[j] = payload
                    break
                if j == 0 and auto:
                    # window 0 resolved the detected language: fan the
                    # remaining windows out fleet-parallel with it
                    lang = finals[0].get("language") or "en"
                    auto = False
                    for k in range(1, n):
                        launch(k, lang)
            with router._lock:
                router.split_requests_total += 1
            step = (N_SAMPLES - overlap) / SAMPLE_RATE
            merged = merge_transcripts(finals, step, overlap / SAMPLE_RATE,
                                       lang)
            wall = time.perf_counter() - t0
            audio_s = audio.size / SAMPLE_RATE
            out = {
                "success": True, "text": merged["text"], "language": lang,
                "audio_seconds": audio_s, "wall_seconds": wall,
                "rtf": wall / max(audio_s, 1e-9), "windows": n,
                "split": "router",
                "tokens": int(sum(r.get("tokens", 0) for r in finals)),
            }
            if str(params["word_timestamps"]).lower() in ("1", "true",
                                                          "yes", "on"):
                out["words"] = merged.get("words", [])
            self._chunk(out)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream
        except Exception as e:  # noqa: BLE001 — headers are already sent:
            # without this the handler would exit mid-chunked-stream,
            # leaving the client a truncated NDJSON body with no failure
            # record. Best-effort error chunk + terminator.
            try:
                self._chunk({"success": False,
                             "error": f"{type(e).__name__}: {e}"})
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
        return True

    def do_POST(self):
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length) if length > 0 else b""
        route, _, query = self.path.partition("?")
        qs = {k: v[-1] for k, v in parse_qs(query).items()}
        streaming = (self.headers.get("X-Stream") == "1"
                     or qs.get("stream") == "1")
        # cheap pre-gate: a body too small to hold >30 s of audio cannot
        # need a split — skip the full multipart/WAV parse+decode the old
        # path paid on EVERY short request. 16 kHz mono int16
        # is the densest format load_audio accepts at 2 B/sample; denser-
        # than-real encodings (e.g. low-rate WAVs) just fall back to the
        # single-backend relay, where the engine still windows internally.
        from ..config import N_SAMPLES as _NS

        may_be_long = len(body) > 2 * _NS
        if (route in ("/asr", "/transcribe") and may_be_long
                and self.router.split_longform
                and len(self.router.backends) > 1):
            try:
                if streaming:
                    if self._maybe_stream_split_longform(body, qs):
                        return
                elif self._maybe_split_longform(body, qs):
                    return
            except ConnectionError as e:
                self._send(503, {"success": False, "error": str(e)})
                return
            except RuntimeError as e:
                self._send(502, {"success": False,
                                 "error": f"window decode failed: {e}"})
                return
        try:
            b, resp, conn = self.router.forward(
                "POST", self.path, body, dict(self.headers))
        except ConnectionError as e:
            self._send(503, {"success": False, "error": str(e)})
            return
        try:
            self.send_response(resp.status)
            is_chunked = (resp.getheader("Transfer-Encoding", "")
                          .lower() == "chunked")
            for k, v in resp.getheaders():
                if k.lower() not in HOP_HEADERS:
                    self.send_header(k, v)
            if is_chunked:
                # streaming (NDJSON partials): relay incrementally
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    chunk = resp.read(16384)
                    if not chunk:
                        break
                    self.wfile.write(f"{len(chunk):x}\r\n".encode()
                                     + chunk + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            else:
                payload = resp.read()
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-relay
        finally:
            self.router.release(b, conn)


def make_router(backend_urls: List[str], host: str = "0.0.0.0",
                port: int = 8000, cooldown_s: float = 2.0,
                split_longform: bool = True,
                longform_overlap_s: float = 2.0) -> ThreadingHTTPServer:
    router = Router(backend_urls, cooldown_s=cooldown_s,
                    split_longform=split_longform,
                    longform_overlap_s=longform_overlap_s)
    handler = type("BoundRouter", (RouterHandler,), {"router": router})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.router = router  # exposed for tests/metrics
    return srv
