"""The port's data-parallel router (CPU): its policy and request parsing on
the same call sequences as ``whisper_tpu/serving/router.py``, the live
fleet of two in-process port engines (test-nano, fp32) behind it as
``tests/test_router.py`` holds the JAX fleet (fan-out, health and metrics,
failover, the long split and its merged words, the streamed split,
passthrough, split disabled), the split's replies against the JAX router's
in front of the same engines, and a ``--dp 2`` fleet of worker processes."""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from whisper_tpu.serving import router as jr
from whisper_tpu.utils import native as jax_native
from whisper_tpu_torch.config import get_config
from whisper_tpu_torch.params import init_params
from whisper_tpu_torch.serving import router as tr
from whisper_tpu_torch.serving.__main__ import parse_args, worker_command
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer
from whisper_tpu_torch.utils import native as port_native

torch.set_num_threads(2)

CFG = get_config("test-nano")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- policy
def _routers(urls, **kw):
    return jr.Router(urls, **kw), tr.Router(urls, **kw)


def test_pick_least_in_flight_equals_jax():
    urls = ["http://a:1", "http://b:1", "http://c:1"]
    picks = []
    for r in _routers(urls):
        for b, n in zip(r.backends, (2, 0, 1)):
            b.in_flight = n
        picks.append([r.pick().url for _ in range(3)])
        r.backends[1].in_flight = 3
        picks[-1].append(r.pick().url)
    assert picks[0] == picks[1] == ["http://b:1"] * 3 + ["http://c:1"]


def test_pick_round_robins_ties_as_jax():
    """Ties go round-robin in the same order, through a change of the tied
    set."""
    urls = ["http://a:1", "http://b:1", "http://c:1"]
    seqs = []
    for r in _routers(urls):
        seq = [r.pick().url for _ in range(5)]
        r.backends[0].in_flight = 1
        seq += [r.pick().url for _ in range(4)]
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert set(seqs[1][:3]) == set(urls)


def test_mark_down_and_healthy_as_jax():
    for r in _routers(["http://a:1", "http://b:1"], cooldown_s=30.0):
        r.mark_down(r.backends[0])
        assert not r.backends[0].healthy() and r.backends[1].healthy()
        assert r.backends[0].errors_total == 1
        assert r.pick().url == "http://b:1"
        assert r.pick(exclude={id(r.backends[1])}) is None  # a down, b excluded
        r.backends[0].down_until = 0.0  # cooldown over
        r.backends[1].in_flight = 1
        assert r.pick().url == "http://a:1"
        assert r.backends[0].hostport == ("a", 1)
        assert tr.Backend(url="h:9").hostport == jr.Backend(url="h:9").hostport == ("h", 9)


# ---------------------------------------------------------------- request parsing
def _wav_bytes(x: np.ndarray, rate: int = 16000) -> bytes:
    pcm = x.astype("<f4").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, rate, rate * 4, 4, 32)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _multipart(fields: dict, boundary: str = "RB") -> tuple:
    body = b""
    for k, v in fields.items():
        disp = f'form-data; name="{k}"' + ('; filename="a.wav"' if k == "wav" else "")
        body += f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode()
        body += (v if isinstance(v, bytes) else v.encode()) + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


@pytest.fixture()
def same_native_route():
    """Both packages look for the native library afresh, so their WAV loads
    take the same route (a library built by another test in this process
    after one of them looked would split them)."""
    jax_native.load_native.cache_clear()
    port_native.load_native.cache_clear()
    yield
    jax_native.load_native.cache_clear()
    port_native.load_native.cache_clear()


def test_parse_asr_request_equals_jax(same_native_route):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(3200) * 0.2).astype(np.float32)
    wav = _wav_bytes(x, 8000)
    prompt = "中文词汇表"
    wire = prompt.encode("utf-8").decode("latin-1")  # as http.server delivers it
    mp, mp_type = _multipart({"wav": wav, "language": "en", "beam": "3", "format": "srt"})
    cases = [
        (mp, mp_type, {}, {"temperature": "0.4"}),
        (x.tobytes(), "application/octet-stream",
         {"X-Initial-Prompt": wire, "X-Language": "zh", "X-Beam": "2",
          "X-Word-Timestamps": "1", "X-Condition-On-Previous": "1"}, {}),
        (x.tobytes(), "application/octet-stream", {"X-Initial-Prompt": "hello"},
         {"format": "txt"}),
        (wav, "audio/wav", {}, {"language": "auto"}),
        (x.tobytes()[:-1], "application/octet-stream", {}, {}),  # not whole f32 samples
        (b"garbage", "audio/wav", {}, {}),
        (_multipart({"language": "en"})[0], mp_type, {}, {}),  # no wav field
    ]
    for body, ctype, headers, qs in cases:
        want = jr._parse_asr_request(body, ctype, headers, qs)
        got = tr._parse_asr_request(body, ctype, headers, qs)
        if want is None:
            assert got is None, ctype
            continue
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    got = tr._parse_asr_request(*cases[1][:3], {})
    assert got[1]["initial_prompt"] == prompt and got[1]["beam"] == "2"
    assert tr._parse_asr_request(*cases[0][:3], {})[1]["format"] == "srt"


# ---------------------------------------------------------------- live fleet
def _engine():
    return ContinuousBatchingEngine(
        init_params(CFG, seed=0, device="cpu"), get_tokenizer(num_languages=CFG.num_languages),
        max_slots=2, compute_dtype=torch.float32, steps_per_sync=2, max_tokens=8,
        no_speech_threshold=None, logprob_threshold=None,
        compression_ratio_threshold=None).start(warm=False)


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


@pytest.fixture()
def two_replicas():
    """Two port engines + servers on loopback, the port router in front."""
    engines = [_engine() for _ in range(2)]
    servers = [make_server(e, "127.0.0.1", 0, request_timeout_s=120) for e in engines]
    threads = [_serve(s) for s in servers]
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    router_srv = tr.make_router(urls, "127.0.0.1", 0, cooldown_s=0.2)
    threads.append(_serve(router_srv))
    yield router_srv, servers, engines, urls
    for s in [router_srv] + servers:
        s.shutdown()
        s.server_close()
    for e in engines:
        e.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()


def _pcm(seed: int, seconds: float) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
            ).astype(np.float32)


def _post_pcm(port: int, pcm: np.ndarray, query: str = "language=zh", timeout: float = 120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/asr?{query}", data=pcm.tobytes(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:  # degraded: 503 with a JSON body
        return e.code, json.loads(e.read().decode())


def test_router_fans_out(two_replicas):
    router_srv, _, engines, _ = two_replicas
    port = router_srv.server_address[1]
    with ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(lambda i: _post_pcm(port, _pcm(i, 0.5)), range(6)))
    assert all(code == 200 and json.loads(body)["success"] for code, _, body in results)
    served = [b.requests_total for b in router_srv.router.backends]
    assert sum(served) == 6 and all(n >= 1 for n in served), served
    assert [e.stats.requests_total for e in engines] == served


def test_router_health_and_metrics_sum_the_backends(two_replicas):
    router_srv, _, engines, urls = two_replicas
    port = router_srv.server_address[1]
    for i in range(3):
        assert _post_pcm(port, _pcm(i, 0.5))[0] == 200
    status, h = _get(port, "/health")
    assert status == 200 and h == {"status": "healthy",
                                   "backends": [{"url": u, "healthy": True} for u in urls]}
    status, m = _get(port, "/metrics")
    snaps = [e.stats.snapshot() for e in engines]
    for key in ("requests_total", "tokens_total", "audio_seconds_total", "queue_depth",
                "active_slots"):
        assert m[key] == pytest.approx(sum(s[key] for s in snaps)), key
    assert m["requests_total"] == 3 and m["router_split_requests"] == 0
    assert [b["router_requests"] for b in m["backends"]] == [
        b.requests_total for b in router_srv.router.backends]
    assert all(b["url"] == u and b["router_errors"] == 0 and b["in_flight"] == 0
               for b, u in zip(m["backends"], urls))
    # each worker's own kernel counts pass through (none launch on the CPU)
    assert all(set(b["kernel_launches"]) >= {"flash_attention_btd", "int8_gemm"}
               and not any(b["kernel_launches"].values()) for b in m["backends"])


def test_router_failover_on_dead_backend(two_replicas):
    """A replica that goes away costs capacity, not availability."""
    router_srv, servers, engines, _ = two_replicas
    port = router_srv.server_address[1]
    servers[0].shutdown()
    servers[0].server_close()  # release the listening socket too
    engines[0].stop()
    for i in range(3):
        code, _, body = _post_pcm(port, _pcm(i, 0.5))
        assert code == 200 and json.loads(body)["success"]
    assert router_srv.router.backends[1].requests_total >= 3
    assert router_srv.router.backends[0].errors_total >= 1
    status, h = _get(port, "/health")
    assert status == 503 and h["status"] == "degraded"
    assert _get(port, "/metrics")[1]["backends"][0]["unreachable"] is True


def test_router_splits_longform_across_backends_as_jax(two_replicas):
    """A 70 s request is split into 3 windows at the router and fanned out
    over BOTH replicas; the merged reply (text, words, counts) equals the
    JAX router's in front of the same engines."""
    router_srv, _, engines, urls = two_replicas
    port = router_srv.server_address[1]
    pcm = _pcm(7, 70)
    code, _, body = _post_pcm(port, pcm, "language=en&word_timestamps=1", timeout=300)
    got = json.loads(body)
    assert code == 200 and got["success"] and got["split"] == "router"
    assert got["windows"] == 3 and got["audio_seconds"] == pytest.approx(70.0)
    served = [b.requests_total for b in router_srv.router.backends]
    assert sum(served) == 3 and all(n >= 1 for n in served), served
    assert router_srv.router.metrics()["router_split_requests"] == 1
    # each engine saw only <= 30 s windows, so none split again
    assert sum(e.stats.snapshot()["requests_total"] for e in engines) == 3
    starts = [w["start"] for w in got["words"]]
    assert got["words"] and starts == sorted(starts)
    assert all(0 <= w["start"] <= w["end"] <= 70.5 for w in got["words"])

    jax_srv = jr.make_router(urls, "127.0.0.1", 0)
    t = _serve(jax_srv)
    try:
        code, _, body = _post_pcm(jax_srv.server_address[1], pcm,
                                  "language=en&word_timestamps=1", timeout=300)
    finally:
        jax_srv.shutdown()
        jax_srv.server_close()
        t.join(timeout=10)
    want = json.loads(body)
    for key in ("text", "words", "windows", "tokens", "language", "audio_seconds", "split",
                "avg_logprob", "no_speech_prob", "compression_ratio"):
        assert got.get(key) == want.get(key), key
    # srt from the same windows: rendered by the router from the merged words
    code, ctype, srt = _post_pcm(port, pcm, "language=en&format=srt", timeout=300)
    assert code == 200 and ctype.startswith("application/x-subrip") and "-->" in srt


def test_router_streaming_longform_split_as_jax(two_replicas):
    """A streamed 70 s request fans out AND keeps its NDJSON stream: window
    partials in window order, then the merged reply, whose text equals the
    JAX router's."""
    router_srv, _, engines, urls = two_replicas
    port = router_srv.server_address[1]
    pcm = _pcm(8, 70)

    def lines_of(p):
        code, ctype, body = _post_pcm(p, pcm, "language=zh&stream=1", timeout=300)
        assert code == 200 and "ndjson" in ctype
        return [json.loads(ln) for ln in body.splitlines() if ln]

    lines = lines_of(port)
    final = lines[-1]
    assert final["success"] is True and final["split"] == "router" and final["windows"] == 3
    partials = [ln for ln in lines[:-1] if "partial" in ln]
    assert partials, "no window partials relayed"
    wins = [p["window"] for p in partials]
    assert wins == sorted(wins)
    assert sum(e.stats.requests_total for e in engines) == 3
    assert all(b.requests_total >= 1 for b in router_srv.router.backends)

    jax_srv = jr.make_router(urls, "127.0.0.1", 0)
    t = _serve(jax_srv)
    try:
        want = lines_of(jax_srv.server_address[1])[-1]
    finally:
        jax_srv.shutdown()
        jax_srv.server_close()
        t.join(timeout=10)
    assert {k: final[k] for k in ("text", "windows", "tokens", "language")} == {
        k: want[k] for k in ("text", "windows", "tokens", "language")}


def test_router_streaming_passthrough(two_replicas):
    """A short streamed request relays chunk by chunk from one backend."""
    router_srv, _, _, _ = two_replicas
    port = router_srv.server_address[1]
    code, ctype, body = _post_pcm(port, _pcm(3, 1.0), "language=zh&stream=1")
    lines = [json.loads(ln) for ln in body.splitlines() if ln]
    assert code == 200 and "ndjson" in ctype and lines[-1]["success"] is True
    assert "split" not in lines[-1]
    assert sum(b.requests_total for b in router_srv.router.backends) == 1


def test_router_split_disabled_keeps_affinity(two_replicas):
    """With the split off the long request goes untouched to ONE backend,
    which windows it itself."""
    _, _, _, urls = two_replicas
    srv = tr.make_router(urls, "127.0.0.1", 0, split_longform=False, longform_overlap_s=1.5)
    t = _serve(srv)
    try:
        assert srv.router.split_longform is False and srv.router.longform_overlap_s == 1.5
        code, _, body = _post_pcm(srv.server_address[1], _pcm(9, 70), timeout=300)
        body = json.loads(body)
        assert code == 200 and body["success"] and body.get("split") != "router"
        assert body["windows"] == 3  # the engine's own split
        served = [b.requests_total for b in srv.router.backends]
        assert sum(served) == 1, served
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


# ---------------------------------------------------------------- --dp 2
@pytest.mark.parametrize("flags", [
    [],
    ["--model_type", "test-nano", "--device", "cpu", "--dtype", "float32", "--no-w8a8",
     "--no-kv_quant", "--slots", "3", "--steps_per_sync", "5", "--max_tokens", "0",
     "--timestamps", "--adaptive_sync", "--encode_chunks", "2", "--admit_chunk", "1",
     "--length_penalty=-0.5", "--checkpoint", "w.pt", "--temperature_fallback", "",
     "--encoder_attention", "bhtd", "--cross_decode", "dense", "--router_overlap_s", "1.5",
     "--max_beam_size", "4", "--beam_batch_max", "2", "--no_speech_threshold", "-1",
     "--logprob_threshold=-1e+20", "--compression_ratio_threshold", "3", "--timeout", "9",
     "--tp", "2"]])
def test_worker_command_carries_every_engine_flag(flags):
    """A ``--dp`` worker's command line parses back to the fleet's own
    engine flags (the JAX worker's set, plus the port's device and kernel
    selections), on its own host and port."""
    args = parse_args(["--dp", "2", "--port", "9000", *flags])
    cmd = worker_command(args, 9001)
    assert cmd[1:3] == ["-m", "whisper_tpu_torch.serving"]
    back = vars(parse_args(cmd[3:]))
    want = vars(args)
    for key in ("host", "port", "dp"):
        want.pop(key), back.pop(key)
    assert back == want
    assert cmd[cmd.index("--port") + 1] == "9001" and "--dp" not in cmd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie has exited
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_dp2_fleet_serves_and_sigterm_leaves_no_process():
    """``python -m whisper_tpu_torch.serving --dp 2`` on the CPU: two worker
    processes behind the router; concurrent requests reach both, and a
    SIGTERM to the orchestrator takes every worker down with it."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_tpu_torch.serving", "--dp", "2", "--device", "cpu",
         "--model_type", "test-nano", "--port", str(port), "--host", "127.0.0.1",
         "--dtype", "float32", "--no-w8a8", "--slots", "2", "--max_tokens", "6",
         "--steps_per_sync", "2", "--worker_startup_timeout", "120"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 150
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()
            try:
                if _get(port, "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.5)
        else:
            pytest.fail("the router never became healthy")
        with ThreadPoolExecutor(max_workers=4) as ex:
            results = list(ex.map(lambda i: _post_pcm(port, _pcm(i, 0.5)), range(6)))
        assert all(code == 200 and json.loads(body)["success"] for code, _, body in results)
        _, m = _get(port, "/metrics")
        per = [b["router_requests"] for b in m["backends"]]
        assert sum(per) == 6 and all(n >= 1 for n in per), per
        assert [b["url"] for b in m["backends"]] == [
            f"http://127.0.0.1:{port + 1 + i}" for i in range(2)]
        workers = [int(p) for p in subprocess.run(
            ["pgrep", "-P", str(proc.pid)], capture_output=True, text=True).stdout.split()]
        assert len(workers) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not [w for w in workers if _alive(w)]
    finally:
        if proc.poll() is None:
            proc.kill()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
