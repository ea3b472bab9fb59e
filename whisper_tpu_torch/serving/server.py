"""HTTP serving front end over the continuous-batching engine.

Port of ``whisper_tpu/serving/server.py``. Both reference wire protocols on
``POST /asr`` (and ``/transcribe``):

- multipart/form-data with a ``wav`` file field (+ optional ``language`` /
  ``task`` fields) — the Python reference server (python/whisper_svr.py);
- application/octet-stream raw little-endian f32 16 kHz PCM, length % 4
  checked — the C++ reference server (cpp/src/WhisperHTTPServer.hpp);
- any other content type: a bare WAV body.

``GET /health`` and ``GET /metrics`` (engine stats, and under
``kernel_launches`` each hand-written kernel's launches in this process, so
a fleet's workers can be counted from outside); JSON responses with CORS
headers. Request options come from the query string, ``X-`` headers
(``X-Initial-Prompt`` is read as UTF-8) or multipart fields:
``beam`` (1 to the engine's ``max_beam_size``; above 1 the engine's aux
worker decodes by beam search and the reply carries ``beam_size``),
``temperature`` (0 to 2; above 0 the engine samples on its aux worker),
``language=auto`` (detected; the reply's ``language`` names the code),
``initial_prompt``, ``condition_on_previous`` (for audio over 30 s, which is
split into windows and merged), ``word_timestamps`` (the reply's
``words``, from the engine's align worker), ``format`` txt, srt, vtt or tsv
(the CLI's writers; srt, vtt and tsv build their segments from word
timings, so they turn ``word_timestamps`` on, as the JAX server does) and
``stream=1`` (``X-Stream: 1``: chunked NDJSON, one ``{"partial": text}``
line per decode round, then the reply). Status codes: 400 for bad input
(``stream`` with a ``format`` other than json too, a ``beam`` outside
1..``max_beam_size``), 501 for a request option the engine refuses as not
ported (the reply names it), 503 when the engine's queue is full, 504 on
timeout, 500 otherwise.
"""

from __future__ import annotations

import json
import queue
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..formats import HTTP_CONTENT_TYPES, render_payload
from ..ops.audio import WavFormatError, load_audio, pcm_f32_from_bytes
from .engine import ContinuousBatchingEngine, OverloadedError, Request
from .wire import parse_multipart

_TRUE = ("1", "true", "yes", "on")
_OPTIONS = ("language", "task", "beam", "temperature", "word_timestamps", "initial_prompt",
            "condition_on_previous", "format", "stream")


def kernel_launches() -> dict:
    """Launches of every kernel wrapper in this process, by its name (each
    counts only where it launches its CUDA kernel, or where a graph replay
    runs its launches)."""
    from ..utils.graphs import kernel_wrappers

    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


class WhisperHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    engine: ContinuousBatchingEngine = None  # set by make_server
    request_timeout_s: float = 300.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload: dict):
        self._send_text(code, json.dumps(payload, ensure_ascii=False),
                        "application/json; charset=utf-8")

    def _send_text(self, code: int, text: str, content_type: str):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        # CORS, like the C++ server (cpp/src/WhisperHTTPServer.hpp:36-38)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "POST, GET, OPTIONS")
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, code: int, error: str):
        self._send(code, {"success": False, "error": error})

    def _stream_request(self, req: Request):
        """Chunked NDJSON: one ``{"partial": text}`` line each time the
        transcript changes, then the reply (or an error object). The request
        is submitted before the 200 goes out, so a refusal still gets its
        status code."""
        partials: "queue.Queue[str]" = queue.Queue()
        req.on_partial = partials.put
        fut = self.engine.submit(req)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj, ensure_ascii=False) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        t0, last = time.monotonic(), None
        try:
            while not fut.done():
                try:
                    p = partials.get(timeout=0.05)
                except queue.Empty:
                    p = None
                if p is not None and p != last:
                    chunk({"partial": p})
                    last = p
                if time.monotonic() - t0 > self.request_timeout_s:
                    fut.cancel()
                    break
            try:
                chunk(fut.result(timeout=0))
            except Exception as e:  # noqa: BLE001 — the status line is gone: report inline
                error = "inference timeout" if fut.cancelled() else f"{type(e).__name__}: {e}"
                chunk({"success": False, "error": error})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            req.on_partial = None  # the client went away

    def do_GET(self):
        if self.path == "/health":
            self._send(200, {"status": "healthy"})
        elif self.path == "/metrics":
            self._send(200, {**self.engine.stats.snapshot(),
                             "kernel_launches": kernel_launches()})
        else:
            self._fail(404, "not found")

    def do_OPTIONS(self):
        self._send(200, {})

    def _read_request(self):
        """(audio, options): options from the query string, then X- headers
        (``X-Language``, ``X-Beam``, ``X-Word-Timestamps``, ...), then
        multipart fields, each overriding the one before."""
        query = self.path.partition("?")[2]
        opts = {k: v[-1] for k, v in parse_qs(query).items()}
        for key in _OPTIONS:
            value = self.headers.get("X-" + "-".join(w.capitalize() for w in key.split("_")))
            if value:
                if key == "initial_prompt":
                    # header values arrive as latin-1: recover a UTF-8 prompt
                    try:
                        value = value.encode("latin-1").decode("utf-8")
                    except (UnicodeDecodeError, UnicodeEncodeError):
                        pass
                opts[key] = value
        length = int(self.headers.get("Content-Length", "0"))
        if length <= 0:
            raise ValueError("empty body")
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        if ctype.startswith("multipart/form-data"):
            fields = parse_multipart(body, ctype)
            if "wav" not in fields:
                raise ValueError("missing wav field")
            audio = load_audio(fields["wav"])
            opts.update({k: fields[k] for k in _OPTIONS if fields.get(k)})
        elif ctype.startswith("application/octet-stream"):
            if len(body) % 4 != 0:
                # C++ server semantics (WhisperHTTPServer.hpp:60-71)
                raise ValueError("binary data size must be multiple of 4")
            audio = pcm_f32_from_bytes(body)
        else:
            audio = load_audio(body)  # bare WAV body as a convenience
        return audio, opts

    def do_POST(self):
        route = self.path.partition("?")[0]
        if route not in ("/asr", "/transcribe"):
            self._fail(404, "not found")
            return
        try:
            audio, opts = self._read_request()
            if audio.size == 0:
                raise ValueError("empty audio")
            try:
                beam = int(opts.get("beam", "1"))
            except ValueError:
                raise ValueError(f"bad beam {opts['beam']!r}") from None
            if not 1 <= beam <= self.engine.max_beam_size:
                raise ValueError(f"beam must be in 1..{self.engine.max_beam_size}")
            try:
                temperature = float(opts.get("temperature", "0"))
            except ValueError:
                raise ValueError(f"bad temperature {opts['temperature']!r}") from None
            if not (0.0 <= temperature <= 2.0):
                raise ValueError("temperature must be in [0, 2]")
            fmt = opts.get("format", "json").lower()
            if fmt not in HTTP_CONTENT_TYPES:
                raise ValueError(f"bad format {fmt!r}; known: {sorted(HTTP_CONTENT_TYPES)}")
            # subtitle segments come from word timings
            word_ts = (opts.get("word_timestamps", "0").lower() in _TRUE
                       or fmt in ("srt", "vtt", "tsv"))
            stream = opts.get("stream", "0").lower() in _TRUE
            if stream and fmt != "json":
                raise ValueError("format is not supported with streaming (NDJSON only)")
            req = Request(
                audio=audio, language=opts.get("language", "zh"),
                task=opts.get("task", "transcribe"), beam_size=beam, temperature=temperature,
                word_timestamps=word_ts, initial_prompt=opts.get("initial_prompt") or None,
                condition_on_previous=opts.get("condition_on_previous", "0").lower() in _TRUE)
            if stream:
                self._stream_request(req)
                return
            result = self.engine.submit(req).result(timeout=self.request_timeout_s)
            if fmt == "json":
                self._send(200, result)
            else:
                self._send_text(200, render_payload(result, fmt), HTTP_CONTENT_TYPES[fmt])
        except NotImplementedError as e:
            self._fail(501, str(e))
        except OverloadedError as e:
            self._fail(503, str(e))
        except (WavFormatError, ValueError) as e:
            self._fail(400, str(e))
        except TimeoutError:
            self._fail(504, "inference timeout")
        except Exception as e:  # noqa: BLE001 — server must not die
            self._fail(500, f"{type(e).__name__}: {e}")


def make_server(engine: ContinuousBatchingEngine, host: str = "0.0.0.0",
                port: int = 8000, request_timeout_s: float = 300.0) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (WhisperHandler,),
                   {"engine": engine, "request_timeout_s": request_timeout_s})
    return ThreadingHTTPServer((host, port), handler)
