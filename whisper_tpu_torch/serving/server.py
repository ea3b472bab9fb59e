"""HTTP serving front end over the continuous-batching engine.

Port of ``whisper_tpu/serving/server.py``. Both reference wire protocols on
``POST /asr`` (and ``/transcribe``):

- multipart/form-data with a ``wav`` file field (+ optional ``language`` /
  ``task`` fields) — the Python reference server (python/whisper_svr.py);
- application/octet-stream raw little-endian f32 16 kHz PCM, length % 4
  checked — the C++ reference server (cpp/src/WhisperHTTPServer.hpp);
- any other content type: a bare WAV body.

``GET /health`` and ``GET /metrics`` (engine stats); JSON responses with CORS
headers. ``temperature`` (0 to 2) is served: above 0 the engine samples on
its aux worker; ``language=auto`` is detected by the engine and the reply's
``language`` names the code. Status codes: 400 for bad input, 501 for a
request option this port does not serve yet (``beam`` > 1,
``word_timestamps``, ``initial_prompt``, ``condition_on_previous``,
``stream``, ``format`` other than json, audio over 30 s; the reply names
it), 503 when the engine's queue is full, 504 on timeout, 500 otherwise.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..ops.audio import WavFormatError, load_audio, pcm_f32_from_bytes
from .engine import ContinuousBatchingEngine, OverloadedError, Request
from .wire import parse_multipart

FORMATS = ("json", "txt", "srt", "vtt", "tsv")  # the JAX server's; only json is ported
_TRUE = ("1", "true", "yes", "on")
_OPTIONS = ("language", "task", "beam", "temperature", "word_timestamps", "initial_prompt",
            "condition_on_previous", "format", "stream")


class WhisperHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    engine: ContinuousBatchingEngine = None  # set by make_server
    request_timeout_s: float = 300.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload, ensure_ascii=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        # CORS, like the C++ server (cpp/src/WhisperHTTPServer.hpp:36-38)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "POST, GET, OPTIONS")
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, code: int, error: str):
        self._send(code, {"success": False, "error": error})

    def do_GET(self):
        if self.path == "/health":
            self._send(200, {"status": "healthy"})
        elif self.path == "/metrics":
            self._send(200, self.engine.stats.snapshot())
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
            if beam < 1:
                raise ValueError("beam must be >= 1")
            try:
                temperature = float(opts.get("temperature", "0"))
            except ValueError:
                raise ValueError(f"bad temperature {opts['temperature']!r}") from None
            if not (0.0 <= temperature <= 2.0):
                raise ValueError("temperature must be in [0, 2]")
            fmt = opts.get("format", "json").lower()
            if fmt not in FORMATS:
                raise ValueError(f"bad format {fmt!r}; known: {sorted(FORMATS)}")
            server_side = {"format != json": fmt != "json",
                           "stream": opts.get("stream", "0").lower() in _TRUE}
            asked = [name for name, on in server_side.items() if on]
            if asked:
                raise NotImplementedError(
                    f"not ported to whisper_tpu_torch yet: {', '.join(asked)}")
            fut = self.engine.submit(Request(
                audio=audio, language=opts.get("language", "zh"),
                task=opts.get("task", "transcribe"), beam_size=beam, temperature=temperature,
                word_timestamps=opts.get("word_timestamps", "0").lower() in _TRUE,
                initial_prompt=opts.get("initial_prompt") or None,
                condition_on_previous=opts.get("condition_on_previous", "0").lower() in _TRUE))
            self._send(200, fut.result(timeout=self.request_timeout_s))
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
